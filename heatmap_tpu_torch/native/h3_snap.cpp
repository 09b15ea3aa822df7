// Host-side H3 forward snap: (lat, lng) radians -> 64-bit cell index.
//
// A copy of heatmap_tpu/native/h3_snap.cpp for heatmap_tpu_torch, built with
// g++ by heatmap_tpu_torch/_build.py into the port's own library.
//
// The trig-free gnomonic + packed-digit-chain algorithm of the port's
// hexgrid/device.py, in double throughout, so it matches the f64 host
// oracle rather than the f32 device snap (points within ~0.4 m of a cell
// edge at res 9 may differ from the f32 snap; both are valid snaps).  The
// inference engine snaps entity positions with it for the velocity field,
// the forecasts and the anomaly cells, as the reference's engine does.
//
// Two paths share one algorithm:
//   * `snap_one` -- the scalar reference (and the tail/pentagon path);
//   * an AVX-512 block path (8 points/vector) used when the CPU has
//     avx512f+avx512dq (checked at run time, `avx512_ok`): the face
//     argmax, gnomonic projection, hex rounding, and the aperture-7 digit
//     chain all run as f64 vectors.  Every arithmetic step replicates the
//     scalar evaluation order with explicit mul/add (no FMA contraction),
//     and the digit chain's integer work is done in f64 -- exact, because
//     all intermediates stay far below 2^53 and div7_round's operand
//     (2x+7, odd) is never a multiple of 14, so floor((2x+7)/14.0) ==
//     floor-div exactly.
//
//     TRIG + MARGIN FALLBACK: the block path computes sin/cos with a
//     vectorized fdlibm-style polynomial (~1 ulp, NOT bit-identical to
//     libm) and proves per lane that the last-ulp trig difference cannot
//     change the DISCRETE outputs:
//       * face argmax margin: best dot minus second-best dot;
//       * hex rounding margin: distance from the scaled hex-plane
//         point to its rounded cell's nearest edge (0.5 - max lattice
//         projection; unit cell spacing).
//     A lane whose margin is below tolerance (conservatively ~1000x
//     the worst-case f64 error amplification through the projection at
//     res <= 10) is REDONE with scalar `snap_one` (libm sincos), so
//     the library's outputs remain bit-identical to the scalar
//     reference everywhere, by construction: lanes where poly-vs-libm
//     could matter never take the poly result.  Base-cell lookup and the
//     (rare) home-orientation/pentagon rotations run scalar per lane.
//     tests/test_torch_infer.py holds both entries (`h3_snap_f32`,
//     `h3_snap_f32_scalar`) against the reference library's.
//
// All lookup tables are PASSED IN from Python (the port's
// hexgrid/_tables.py through hexgrid/device.py).

#include <cstdint>
#include <cmath>

#if defined(__x86_64__) && defined(__GNUC__)
#define H3_SNAP_AVX512 1
#include <immintrin.h>
#endif

// One call computing both sin and cos, bit-identical to the separate
// libm calls.  glibc exports sincos (a GNU extension); elsewhere fall
// back to std::sin/std::cos so the combined native .so still links
// (an undefined symbol here would silently disable EVERY native
// component — they share one library).
#if defined(__GLIBC__)
extern "C" void sincos(double, double*, double*);
static inline void h3_sincos(double x, double* s, double* c) {
  sincos(x, s, c);
}
#else
static inline void h3_sincos(double x, double* s, double* c) {
  *s = std::sin(x);
  *c = std::cos(x);
}
#endif

namespace {

inline int64_t fdiv(int64_t a, int64_t b) {
  // floor division (jnp.floor_divide semantics for negative a)
  int64_t q = a / b, r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}

inline void ijk_normalize(int64_t& i, int64_t& j, int64_t& k) {
  // mirror mathlib.ijk_normalize: fold negative axes, subtract min
  int64_t neg = i < 0 ? i : 0;
  j -= neg; k -= neg; i -= neg;
  neg = j < 0 ? j : 0;
  i -= neg; k -= neg; j -= neg;
  neg = k < 0 ? k : 0;
  i -= neg; j -= neg; k -= neg;
  int64_t m = i < j ? i : j;
  if (k < m) m = k;
  i -= m; j -= m; k -= m;
}

inline int64_t div7_round(int64_t x) {  // round-half-away of x/7 (exact)
  return fdiv(2 * x + 7, 14);
}

inline void up_ap7(int64_t& i, int64_t& j, int64_t& k) {
  int64_t ii = i - k, jj = j - k;
  i = div7_round(3 * ii - jj);
  j = div7_round(ii + 2 * jj);
  k = 0;
  ijk_normalize(i, j, k);
}

inline void up_ap7r(int64_t& i, int64_t& j, int64_t& k) {
  int64_t ii = i - k, jj = j - k;
  i = div7_round(2 * ii + jj);
  j = div7_round(3 * jj - ii);
  k = 0;
  ijk_normalize(i, j, k);
}

inline void lin3(const int32_t* m /*9 ints: iv, jv, kv*/, int64_t i,
                 int64_t j, int64_t k, int64_t& oi, int64_t& oj,
                 int64_t& ok) {
  oi = i * m[0] + j * m[3] + k * m[6];
  oj = i * m[1] + j * m[4] + k * m[7];
  ok = i * m[2] + j * m[5] + k * m[8];
  ijk_normalize(oi, oj, ok);
}

constexpr double kSin60 = 0.8660254037844386467637231707529362;

inline void hex2d_to_ijk(double x, double y, int64_t& i, int64_t& j,
                         int64_t& k) {
  // exact port of mathlib.hex2d_to_ijk / device._hex2d_to_ijk
  double a1 = std::fabs(x), a2 = std::fabs(y);
  double x2 = a2 / kSin60;
  double x1 = a1 + x2 * 0.5;
  int64_t m1 = (int64_t)std::floor(x1);
  int64_t m2 = (int64_t)std::floor(x2);
  double r1 = x1 - (double)m1, r2 = x2 - (double)m2;
  const double third = 1.0 / 3.0;
  if (r1 < 0.5) {
    if (r1 < third) {
      i = m1;
      j = (r2 < (1.0 + r1) * 0.5) ? m2 : m2 + 1;
    } else {
      j = (r2 < (1.0 - r1)) ? m2 : m2 + 1;
      i = (((1.0 - r1) <= r2) && (r2 < 2.0 * r1)) ? m1 + 1 : m1;
    }
  } else {
    if (r1 < 2.0 * third) {
      j = (r2 < (1.0 - r1)) ? m2 : m2 + 1;
      i = (((2.0 * r1 - 1.0) < r2) && (r2 < (1.0 - r1))) ? m1 : m1 + 1;
    } else {
      i = m1 + 1;
      j = (r2 < r1 * 0.5) ? m2 : m2 + 1;
    }
  }
  if (x < 0.0) {
    bool j_even = (j % 2) == 0;
    int64_t axisi = j_even ? fdiv(j, 2) : fdiv(j + 1, 2);
    int64_t diff = i - axisi;
    i = j_even ? i - 2 * diff : i - (2 * diff + 1);
  }
  if (y < 0.0) {
    i = i - fdiv(2 * j + 1, 2);
    j = -j;
  }
  k = 0;
  ijk_normalize(i, j, k);
}

inline int lead_digit_packed(uint32_t p) {
  if (p == 0) return 0;
  int b = 31 - __builtin_clz(p);
  return (int)((p >> (3 * (b / 3))) & 7u);
}

inline uint32_t rot_fields(uint32_t p, const int32_t* ccw_pow, int rot,
                           int res) {
  uint32_t out = 0;
  for (int f = 0; f < res; ++f) {
    uint32_t d = (p >> (3 * f)) & 7u;
    out |= (uint32_t)ccw_pow[rot * 7 + (int)d] << (3 * f);
  }
  return out;
}

// All the precomputed tables, bundled so the scalar/vector paths share
// one plumbing surface.
struct Tables {
  const double* face_xyz;
  const double* u1;
  const double* u2;
  double rot_cos, rot_sin, scale;
  const int32_t* down_ap7;
  const int32_t* down_ap7r;
  const int32_t* face_ijk_bc;
  const int32_t* face_ijk_rot;
  const int32_t* bc_pent;
  const int32_t* pent_cw_off;
  const int32_t* ccw_pow;
  int k_axes_digit;
};

// Base-cell lookup + home-orientation/pentagon digit rotations — the
// per-lane epilogue shared verbatim by both paths (rotations are
// table-driven and branchy; they run scalar even in the vector path).
inline void finish_cell(const Tables& T, int res, int face, int64_t i,
                        int64_t j, int64_t k, uint32_t p, uint32_t* hi,
                        uint32_t* lo) {
  // res-0 coords are mathematically within [0,2]; clamp for safety
  if (i < 0) i = 0; if (i > 2) i = 2;
  if (j < 0) j = 0; if (j > 2) j = 2;
  if (k < 0) k = 0; if (k > 2) k = 2;

  int flat = (int)(((face * 3 + i) * 3 + j) * 3 + k);
  int bc = T.face_ijk_bc[flat];
  int rot = T.face_ijk_rot[flat];
  if (res > 0) {
    bool pent = T.bc_pent[bc] != 0;
    if (pent) {
      bool cw_off = T.pent_cw_off[bc * 20 + face] != 0;
      if (lead_digit_packed(p) == T.k_axes_digit) {
        // deleted-subsequence offset: leading K rotated out (CW == CCW^5)
        p = rot_fields(p, T.ccw_pow, cw_off ? 5 : 1, res);
      }
      for (int t = 0; t < rot; ++t) {
        uint32_t p1 = rot_fields(p, T.ccw_pow, 1, res);
        if (lead_digit_packed(p1) == T.k_axes_digit)
          p1 = rot_fields(p1, T.ccw_pow, 1, res);
        p = p1;
      }
    } else {
      p = rot_fields(p, T.ccw_pow, rot, res);
    }
  }

  // --- pack (device._pack_packed; mode=1 cell) -----------------------
  uint64_t h = ((uint64_t)1 << 59) | ((uint64_t)res << 52) |
               ((uint64_t)bc << 45);
  h |= (uint64_t)p << (3 * (15 - res));
  for (int r = res + 1; r <= 15; ++r) h |= (uint64_t)7 << (3 * (15 - r));
  *hi = (uint32_t)(h >> 32);
  *lo = (uint32_t)(h & 0xFFFFFFFFull);
}

// One point, scalar — the reference semantics both paths must match.
inline void snap_one(const Tables& T, int res, bool res_class_iii,
                     float latf, float lngf, uint32_t* hi, uint32_t* lo) {
  // --- geo -> face + gnomonic hex2d (device._geo_to_hex2d_vec) -------
  double la = (double)latf, lo_ = (double)lngf;
  // Non-finite coords (NaN-filled invalid rows inside the live prefix)
  // would reach UB double->int64 casts in the digit chain and could
  // pack digit 7, driving rot_fields past the 42-entry ccw_pow table.
  // Their outputs are masked downstream, so pin them to (0,0) here.
  if (!std::isfinite(la) || !std::isfinite(lo_)) { la = 0.0; lo_ = 0.0; }
  double sla, cla, slo, clo;
  h3_sincos(la, &sla, &cla);
  h3_sincos(lo_, &slo, &clo);
  double v0 = cla * clo, v1 = cla * slo, v2 = sla;
  int face = 0;
  double best = -2.0;
  for (int f = 0; f < 20; ++f) {
    double d = v0 * T.face_xyz[3 * f] + v1 * T.face_xyz[3 * f + 1] +
               v2 * T.face_xyz[3 * f + 2];
    if (d > best) { best = d; face = f; }
  }
  double p0 = v0 / best - T.face_xyz[3 * face];
  double p1 = v1 / best - T.face_xyz[3 * face + 1];
  double p2 = v2 / best - T.face_xyz[3 * face + 2];
  double x = p0 * T.u1[3 * face] + p1 * T.u1[3 * face + 1] +
             p2 * T.u1[3 * face + 2];
  double y = p0 * T.u2[3 * face] + p1 * T.u2[3 * face + 1] +
             p2 * T.u2[3 * face + 2];
  if (res_class_iii) {
    double xr = x * T.rot_cos + y * T.rot_sin;
    y = y * T.rot_cos - x * T.rot_sin;
    x = xr;
  }
  x *= T.scale;
  y *= T.scale;

  // --- hex rounding + aperture-7 digit chain (device._forward_digits)
  int64_t i, j, k;
  hex2d_to_ijk(x, y, i, j, k);
  uint32_t p = 0;
  for (int r = res; r >= 1; --r) {
    int64_t li = i, lj = j, lk = k, ci, cj, ck;
    if (r & 1) {  // Class III
      up_ap7(i, j, k);
      lin3(T.down_ap7, i, j, k, ci, cj, ck);
    } else {
      up_ap7r(i, j, k);
      lin3(T.down_ap7r, i, j, k, ci, cj, ck);
    }
    int64_t di = li - ci, dj = lj - cj, dk = lk - ck;
    ijk_normalize(di, dj, dk);
    uint32_t digit = (uint32_t)(4 * di + 2 * dj + dk);
    p |= digit << (3 * (res - r));
  }
  finish_cell(T, res, face, i, j, k, p, hi, lo);
}

#ifdef H3_SNAP_AVX512

// ---- AVX-512 block path: 8 points per __m512d ------------------------
//
// f64 vectors replicate the scalar arithmetic step by step (explicit
// mul/add, no FMA).  "Integer" quantities (i, j, k, digit chain) live
// in f64 lanes: every value stays orders of magnitude below 2^53, all
// products/sums/floors are exact, and div7_round's floor-division
// rounds exactly (see file header), so the lane arithmetic is
// bit-for-bit the scalar integer arithmetic.

#define H3_TGT __attribute__((target("avx512f,avx512dq")))

// ---- vector f64 sincos (fdlibm-style minimax, ~1 ulp) ----------------
//
// Good to ~1 ulp for |x| <= SINCOS_MAX_ABS (GPS radians are <= pi, so
// the 2-constant Cody-Waite pi/2 reduction is far more than enough:
// with |q| <= 11 the reduction error is ~q*6e-28, invisible at f64).
// Lanes outside that range (or non-finite) are reported in `bad` and
// must be redone scalar — snap_one's libm handles any finite input.
// The minimax coefficients are the public fdlibm __kernel_sin /
// __kernel_cos constants (pure mathematical constants, reproduced in
// every libm derivative); the combine differs (mask blends, no
// precision-preserving correction terms — the margin fallback absorbs
// the last-ulp difference vs libm).
constexpr double kSinC1 = -1.66666666666666324348e-01;
constexpr double kSinC2 = 8.33333333332248946124e-03;
constexpr double kSinC3 = -1.98412698298579493134e-04;
constexpr double kSinC4 = 2.75573137070700676789e-06;
constexpr double kSinC5 = -2.50507602534068634195e-08;
constexpr double kSinC6 = 1.58969099521155010221e-10;
constexpr double kCosC1 = 4.16666666666666019037e-02;
constexpr double kCosC2 = -1.38888888888741095749e-03;
constexpr double kCosC3 = 2.48015872894767294178e-05;
constexpr double kCosC4 = -2.75573143513906633035e-07;
constexpr double kCosC5 = 2.08757232129817482790e-09;
constexpr double kCosC6 = -1.13596475577881948265e-11;
constexpr double kPio2Hi = 1.57079632673412561417e+00;   // 33 bits of pi/2
constexpr double kPio2Lo = 6.07710050650619224932e-11;   // next 53 bits
constexpr double kTwoOverPi = 6.36619772367581382433e-01;
constexpr double kSincosMaxAbs = 16.0;

H3_TGT static inline void vsincos(__m512d x, __m512d* s_out,
                                  __m512d* c_out, __mmask8* bad) {
  const __m512d one = _mm512_set1_pd(1.0), half = _mm512_set1_pd(0.5);
  // lanes the poly path must not answer: |x| too large or non-finite
  __m512d ax = _mm512_abs_pd(x);
  __mmask8 in_range =
      _mm512_cmp_pd_mask(ax, _mm512_set1_pd(kSincosMaxAbs), _CMP_LE_OQ);
  *bad = (__mmask8)~in_range;  // unordered (NaN) fails LE -> bad too
  // quadrant: q = round(x * 2/pi); r = (x - q*hi) - q*lo
  __m512d q = _mm512_roundscale_pd(
      _mm512_mul_pd(x, _mm512_set1_pd(kTwoOverPi)),
      _MM_FROUND_TO_NEAREST_INT | _MM_FROUND_NO_EXC);
  __m512d r = _mm512_sub_pd(x, _mm512_mul_pd(q, _mm512_set1_pd(kPio2Hi)));
  r = _mm512_sub_pd(r, _mm512_mul_pd(q, _mm512_set1_pd(kPio2Lo)));
  __m512i qi = _mm512_cvtpd_epi64(q);  // avx512dq

  __m512d z = _mm512_mul_pd(r, r);
  // sin(r) = r + r*z*(S1 + z*(S2 + ... z*S6))
  __m512d sp = _mm512_set1_pd(kSinC6);
  sp = _mm512_add_pd(_mm512_mul_pd(sp, z), _mm512_set1_pd(kSinC5));
  sp = _mm512_add_pd(_mm512_mul_pd(sp, z), _mm512_set1_pd(kSinC4));
  sp = _mm512_add_pd(_mm512_mul_pd(sp, z), _mm512_set1_pd(kSinC3));
  sp = _mm512_add_pd(_mm512_mul_pd(sp, z), _mm512_set1_pd(kSinC2));
  sp = _mm512_add_pd(_mm512_mul_pd(sp, z), _mm512_set1_pd(kSinC1));
  __m512d sr = _mm512_add_pd(r, _mm512_mul_pd(_mm512_mul_pd(r, z), sp));
  // cos(r) = 1 - z/2 + z*z*(C1 + z*(C2 + ... z*C6))
  __m512d cp = _mm512_set1_pd(kCosC6);
  cp = _mm512_add_pd(_mm512_mul_pd(cp, z), _mm512_set1_pd(kCosC5));
  cp = _mm512_add_pd(_mm512_mul_pd(cp, z), _mm512_set1_pd(kCosC4));
  cp = _mm512_add_pd(_mm512_mul_pd(cp, z), _mm512_set1_pd(kCosC3));
  cp = _mm512_add_pd(_mm512_mul_pd(cp, z), _mm512_set1_pd(kCosC2));
  cp = _mm512_add_pd(_mm512_mul_pd(cp, z), _mm512_set1_pd(kCosC1));
  __m512d cr = _mm512_add_pd(
      _mm512_sub_pd(one, _mm512_mul_pd(z, half)),
      _mm512_mul_pd(_mm512_mul_pd(z, z), cp));

  // quadrant combine: n = q & 3
  //   sin(x) = [ sr,  cr, -sr, -cr][n]    cos(x) = [ cr, -sr, -cr,  sr][n]
  __m512i n = _mm512_and_epi64(qi, _mm512_set1_epi64(3));
  __mmask8 swap = _mm512_test_epi64_mask(n, _mm512_set1_epi64(1));
  __mmask8 n_ge2 = _mm512_cmp_epi64_mask(n, _mm512_set1_epi64(2),
                                         _MM_CMPINT_NLT);
  __mmask8 n12 = _mm512_test_epi64_mask(
      _mm512_add_epi64(n, _mm512_set1_epi64(1)), _mm512_set1_epi64(2));
  __m512d s = _mm512_mask_mov_pd(sr, swap, cr);
  __m512d c = _mm512_mask_mov_pd(cr, swap, sr);
  const __m512d zero = _mm512_setzero_pd();
  s = _mm512_mask_sub_pd(s, n_ge2, zero, s);  // negate where n in {2,3}
  c = _mm512_mask_sub_pd(c, n12, zero, c);    // negate where n in {1,2}
  *s_out = s;
  *c_out = c;
}

// Margin tolerances: the poly-vs-libm trig difference propagates to the
// scaled hex coords as at most ~|coord| * few-ulps ~ 1e-10 grid units
// at res 10 (scale 7^5), and to the face dots as ~1e-15.  Tolerances
// sit ~1000x above those bounds; lanes inside the band redo scalar.
constexpr double kHexMarginTol = 1e-7;    // grid units (cell spacing 1)
constexpr double kFaceMarginTol = 1e-12;  // unit-sphere dot difference

H3_TGT static inline __m512d vmin(__m512d a, __m512d b) {
  return _mm512_min_pd(a, b);
}

H3_TGT static inline void vnormalize(__m512d& i, __m512d& j, __m512d& k) {
  const __m512d z = _mm512_setzero_pd();
  __m512d neg = vmin(i, z);
  j = _mm512_sub_pd(j, neg); k = _mm512_sub_pd(k, neg);
  i = _mm512_sub_pd(i, neg);
  neg = vmin(j, z);
  i = _mm512_sub_pd(i, neg); k = _mm512_sub_pd(k, neg);
  j = _mm512_sub_pd(j, neg);
  neg = vmin(k, z);
  i = _mm512_sub_pd(i, neg); j = _mm512_sub_pd(j, neg);
  k = _mm512_sub_pd(k, neg);
  __m512d m = vmin(vmin(i, j), k);
  i = _mm512_sub_pd(i, m); j = _mm512_sub_pd(j, m);
  k = _mm512_sub_pd(k, m);
}

H3_TGT static inline __m512d vfloor(__m512d a) {
  return _mm512_roundscale_pd(a, _MM_FROUND_TO_NEG_INF | _MM_FROUND_NO_EXC);
}

// floor((2x+7)/14): x integer-valued f64; 2x+7 is odd so the quotient is
// never an integer and the f64 division's sub-ulp rounding cannot cross
// a floor boundary — exact round-half-away of x/7, as in the scalar.
H3_TGT static inline __m512d vdiv7_round(__m512d x) {
  const __m512d two = _mm512_set1_pd(2.0), seven = _mm512_set1_pd(7.0),
                fourteen = _mm512_set1_pd(14.0);
  __m512d t = _mm512_add_pd(_mm512_mul_pd(two, x), seven);
  return vfloor(_mm512_div_pd(t, fourteen));
}

H3_TGT static inline void vup_ap7(bool class_iii, __m512d& i, __m512d& j,
                                  __m512d& k) {
  __m512d ii = _mm512_sub_pd(i, k), jj = _mm512_sub_pd(j, k);
  const __m512d two = _mm512_set1_pd(2.0), three = _mm512_set1_pd(3.0);
  if (class_iii) {  // up_ap7: i = (3ii - jj)/7r, j = (ii + 2jj)/7r
    i = vdiv7_round(_mm512_sub_pd(_mm512_mul_pd(three, ii), jj));
    j = vdiv7_round(_mm512_add_pd(ii, _mm512_mul_pd(two, jj)));
  } else {          // up_ap7r: i = (2ii + jj)/7r, j = (3jj - ii)/7r
    i = vdiv7_round(_mm512_add_pd(_mm512_mul_pd(two, ii), jj));
    j = vdiv7_round(_mm512_sub_pd(_mm512_mul_pd(three, jj), ii));
  }
  k = _mm512_setzero_pd();
  vnormalize(i, j, k);
}

H3_TGT static inline void vlin3(const int32_t* m, __m512d i, __m512d j,
                                __m512d k, __m512d& oi, __m512d& oj,
                                __m512d& ok) {
  // oi = i*m0 + j*m3 + k*m6 with the scalar's (a+b)+c association
  __m512d m0 = _mm512_set1_pd((double)m[0]),
          m1 = _mm512_set1_pd((double)m[1]),
          m2 = _mm512_set1_pd((double)m[2]),
          m3 = _mm512_set1_pd((double)m[3]),
          m4 = _mm512_set1_pd((double)m[4]),
          m5 = _mm512_set1_pd((double)m[5]),
          m6 = _mm512_set1_pd((double)m[6]),
          m7 = _mm512_set1_pd((double)m[7]),
          m8 = _mm512_set1_pd((double)m[8]);
  oi = _mm512_add_pd(_mm512_add_pd(_mm512_mul_pd(i, m0),
                                   _mm512_mul_pd(j, m3)),
                     _mm512_mul_pd(k, m6));
  oj = _mm512_add_pd(_mm512_add_pd(_mm512_mul_pd(i, m1),
                                   _mm512_mul_pd(j, m4)),
                     _mm512_mul_pd(k, m7));
  ok = _mm512_add_pd(_mm512_add_pd(_mm512_mul_pd(i, m2),
                                   _mm512_mul_pd(j, m5)),
                     _mm512_mul_pd(k, m8));
  vnormalize(oi, oj, ok);
}

// hex2d rounding, vectorized with blends in place of the scalar's
// branches (each region's conditions are evaluated on all lanes and the
// matching region's (i, j) selected — identical comparisons, identical
// arithmetic, so identical results lane by lane).
H3_TGT static inline void vhex2d_to_ijk(__m512d x, __m512d y, __m512d& io,
                                        __m512d& jo, __m512d& ko) {
  const __m512d half = _mm512_set1_pd(0.5), one = _mm512_set1_pd(1.0),
                two = _mm512_set1_pd(2.0),
                third = _mm512_set1_pd(1.0 / 3.0),
                two_third = _mm512_set1_pd(2.0 / 3.0),
                sin60 = _mm512_set1_pd(kSin60),
                z = _mm512_setzero_pd();
  __m512d a1 = _mm512_abs_pd(x), a2 = _mm512_abs_pd(y);
  __m512d x2 = _mm512_div_pd(a2, sin60);
  __m512d x1 = _mm512_add_pd(a1, _mm512_mul_pd(x2, half));
  __m512d m1 = vfloor(x1), m2 = vfloor(x2);
  __m512d r1 = _mm512_sub_pd(x1, m1), r2 = _mm512_sub_pd(x2, m2);
  __m512d m1p = _mm512_add_pd(m1, one), m2p = _mm512_add_pd(m2, one);

  // region masks on r1 (exclusive, matching the scalar's nesting)
  __mmask8 lt_half = _mm512_cmp_pd_mask(r1, half, _CMP_LT_OQ);
  __mmask8 lt_third = _mm512_cmp_pd_mask(r1, third, _CMP_LT_OQ);
  __mmask8 lt_2third = _mm512_cmp_pd_mask(r1, two_third, _CMP_LT_OQ);
  __mmask8 rA = lt_half & lt_third;                    // r1 < 1/3
  __mmask8 rB = lt_half & (__mmask8)~lt_third;         // [1/3, 1/2)
  __mmask8 rC = (__mmask8)~lt_half & lt_2third;        // [1/2, 2/3)
  __mmask8 rD = (__mmask8)~lt_half & (__mmask8)~lt_2third;  // >= 2/3

  __m512d one_m_r1 = _mm512_sub_pd(one, r1);
  // region A: i=m1; j = r2 < (1+r1)*0.5 ? m2 : m2+1
  __mmask8 jA = _mm512_cmp_pd_mask(
      r2, _mm512_mul_pd(_mm512_add_pd(one, r1), half), _CMP_LT_OQ);
  // regions B, C share j = r2 < (1-r1) ? m2 : m2+1
  __mmask8 jBC = _mm512_cmp_pd_mask(r2, one_m_r1, _CMP_LT_OQ);
  // region B: i = ((1-r1) <= r2 && r2 < 2*r1) ? m1+1 : m1
  __mmask8 iB = _mm512_cmp_pd_mask(one_m_r1, r2, _CMP_LE_OQ) &
                _mm512_cmp_pd_mask(r2, _mm512_mul_pd(two, r1), _CMP_LT_OQ);
  // region C: i = ((2*r1-1) < r2 && r2 < (1-r1)) ? m1 : m1+1
  __mmask8 iC = _mm512_cmp_pd_mask(
                    _mm512_sub_pd(_mm512_mul_pd(two, r1), one), r2,
                    _CMP_LT_OQ) &
                _mm512_cmp_pd_mask(r2, one_m_r1, _CMP_LT_OQ);
  // region D: i=m1+1; j = r2 < r1*0.5 ? m2 : m2+1
  __mmask8 jD = _mm512_cmp_pd_mask(r2, _mm512_mul_pd(r1, half), _CMP_LT_OQ);

  __m512d i = m1, j = m2;
  i = _mm512_mask_mov_pd(i, rB & iB, m1p);
  i = _mm512_mask_mov_pd(i, rC & (__mmask8)~iC, m1p);
  i = _mm512_mask_mov_pd(i, rD, m1p);
  j = _mm512_mask_mov_pd(j, rA & (__mmask8)~jA, m2p);
  j = _mm512_mask_mov_pd(j, (rB | rC) & (__mmask8)~jBC, m2p);
  j = _mm512_mask_mov_pd(j, rD & (__mmask8)~jD, m2p);

  // x < 0 fold.  j >= 0 here, so fdiv(j,2) == floor(j*0.5) and
  // fdiv(j+1,2) == floor((j+1)*0.5), both exact (mul by 0.5 is exact).
  __mmask8 xneg = _mm512_cmp_pd_mask(x, z, _CMP_LT_OQ);
  __m512d jhalf = _mm512_mul_pd(j, half);
  __m512d jfl = vfloor(jhalf);
  __mmask8 j_even = _mm512_cmp_pd_mask(jfl, jhalf, _CMP_EQ_OQ);
  __m512d axisi = _mm512_mask_mov_pd(
      vfloor(_mm512_mul_pd(_mm512_add_pd(j, one), half)), j_even, jfl);
  __m512d diff = _mm512_sub_pd(i, axisi);
  __m512d twodiff = _mm512_mul_pd(two, diff);
  __m512d folded = _mm512_sub_pd(i, twodiff);                  // j even
  __m512d folded_odd = _mm512_sub_pd(i, _mm512_add_pd(twodiff, one));
  __m512d xfold = _mm512_mask_mov_pd(folded_odd, j_even, folded);
  i = _mm512_mask_mov_pd(i, xneg, xfold);

  // y < 0 fold: i -= fdiv(2j+1, 2); j = -j.  j >= 0, so
  // fdiv(2j+1,2) == floor(j + 0.5) == j exactly — but keep the full
  // formula so the equivalence is the formula's, not this comment's.
  __mmask8 yneg = _mm512_cmp_pd_mask(y, z, _CMP_LT_OQ);
  __m512d halfterm = vfloor(_mm512_mul_pd(
      _mm512_add_pd(_mm512_mul_pd(two, j), one), half));
  i = _mm512_mask_mov_pd(i, yneg, _mm512_sub_pd(i, halfterm));
  j = _mm512_mask_mov_pd(j, yneg, _mm512_sub_pd(z, j));

  __m512d k = z;
  vnormalize(i, j, k);
  io = i; jo = j; ko = k;
}

// One 8-lane block: poly trig -> face argmax -> projection -> hex
// rounding -> digit chain, PLUS the decision-margin proof.  Returns in
// `fallback` the lanes whose outputs must NOT be used (trig out of
// range / non-finite input / margin below tolerance) — the caller
// redoes those with scalar snap_one, keeping the library bit-identical
// to the scalar reference everywhere.
H3_TGT static void snap_block8(const Tables& T, int res,
                               bool res_class_iii, const float* latf,
                               const float* lngf, int32_t* face_out,
                               double* p_out, double* i_out,
                               double* j_out, double* k_out,
                               __mmask8* fallback) {
  __m512d la = _mm512_cvtps_pd(_mm256_loadu_ps(latf));
  __m512d lo = _mm512_cvtps_pd(_mm256_loadu_ps(lngf));
  __m512d sla, cla, slo, clo;
  __mmask8 bad_la, bad_lo;
  vsincos(la, &sla, &cla, &bad_la);
  vsincos(lo, &slo, &clo, &bad_lo);
  __mmask8 redo = bad_la | bad_lo;
  __m512d v0 = _mm512_mul_pd(cla, clo);
  __m512d v1 = _mm512_mul_pd(cla, slo);
  __m512d v2 = sla;

  // --- face argmax: d > best keeps the FIRST maximal face, as scalar;
  //     second-best dot rides along for the decision margin
  __m512d best = _mm512_set1_pd(-2.0), best2 = _mm512_set1_pd(-2.0);
  __m512i face = _mm512_setzero_si512();
  for (int f = 0; f < 20; ++f) {
    __m512d fx = _mm512_set1_pd(T.face_xyz[3 * f]),
            fy = _mm512_set1_pd(T.face_xyz[3 * f + 1]),
            fz = _mm512_set1_pd(T.face_xyz[3 * f + 2]);
    __m512d d = _mm512_add_pd(
        _mm512_add_pd(_mm512_mul_pd(v0, fx), _mm512_mul_pd(v1, fy)),
        _mm512_mul_pd(v2, fz));
    __mmask8 gt = _mm512_cmp_pd_mask(d, best, _CMP_GT_OQ);
    best2 = _mm512_mask_mov_pd(_mm512_max_pd(best2, d), gt, best);
    best = _mm512_mask_mov_pd(best, gt, d);
    face = _mm512_mask_mov_epi64(face, gt, _mm512_set1_epi64(f));
  }
  redo |= _mm512_cmp_pd_mask(
      _mm512_sub_pd(best, best2), _mm512_set1_pd(kFaceMarginTol),
      _CMP_LT_OQ);
  __m256i face32 = _mm512_cvtepi64_epi32(face);
  __m256i idx3 = _mm256_mullo_epi32(face32, _mm256_set1_epi32(3));

  // --- gnomonic projection with per-lane face tables (gathers) -------
  __m512d fx = _mm512_i32gather_pd(idx3, T.face_xyz, 8);
  __m512d fy = _mm512_i32gather_pd(
      _mm256_add_epi32(idx3, _mm256_set1_epi32(1)), T.face_xyz, 8);
  __m512d fz = _mm512_i32gather_pd(
      _mm256_add_epi32(idx3, _mm256_set1_epi32(2)), T.face_xyz, 8);
  __m512d p0 = _mm512_sub_pd(_mm512_div_pd(v0, best), fx);
  __m512d p1 = _mm512_sub_pd(_mm512_div_pd(v1, best), fy);
  __m512d p2 = _mm512_sub_pd(_mm512_div_pd(v2, best), fz);
  __m512d u1x = _mm512_i32gather_pd(idx3, T.u1, 8);
  __m512d u1y = _mm512_i32gather_pd(
      _mm256_add_epi32(idx3, _mm256_set1_epi32(1)), T.u1, 8);
  __m512d u1z = _mm512_i32gather_pd(
      _mm256_add_epi32(idx3, _mm256_set1_epi32(2)), T.u1, 8);
  __m512d u2x = _mm512_i32gather_pd(idx3, T.u2, 8);
  __m512d u2y = _mm512_i32gather_pd(
      _mm256_add_epi32(idx3, _mm256_set1_epi32(1)), T.u2, 8);
  __m512d u2z = _mm512_i32gather_pd(
      _mm256_add_epi32(idx3, _mm256_set1_epi32(2)), T.u2, 8);
  __m512d x = _mm512_add_pd(
      _mm512_add_pd(_mm512_mul_pd(p0, u1x), _mm512_mul_pd(p1, u1y)),
      _mm512_mul_pd(p2, u1z));
  __m512d y = _mm512_add_pd(
      _mm512_add_pd(_mm512_mul_pd(p0, u2x), _mm512_mul_pd(p1, u2y)),
      _mm512_mul_pd(p2, u2z));
  if (res_class_iii) {
    __m512d rc = _mm512_set1_pd(T.rot_cos), rs = _mm512_set1_pd(T.rot_sin);
    __m512d xr = _mm512_add_pd(_mm512_mul_pd(x, rc), _mm512_mul_pd(y, rs));
    y = _mm512_sub_pd(_mm512_mul_pd(y, rc), _mm512_mul_pd(x, rs));
    x = xr;
  }
  __m512d sc = _mm512_set1_pd(T.scale);
  x = _mm512_mul_pd(x, sc);
  y = _mm512_mul_pd(y, sc);

  // --- hex rounding + digit chain ------------------------------------
  __m512d i, j, k;
  vhex2d_to_ijk(x, y, i, j, k);

  // decision margin for the rounding: distance from (x, y) to the
  // rounded cell's nearest edge.  Cell center via the lattice inverse
  // (i' = i-k, j' = j-k; cx = i' - j'/2, cy = j'*sin60 — unit
  // spacing), then margin = 1/2 - max |projection on the 3 neighbor
  // directions (1,0), (±1/2, sin60)|.  A lane inside the tolerance
  // band could round differently under libm-vs-poly trig: redo scalar.
  {
    __m512d ip = _mm512_sub_pd(i, k), jp = _mm512_sub_pd(j, k);
    __m512d cx = _mm512_sub_pd(
        ip, _mm512_mul_pd(jp, _mm512_set1_pd(0.5)));
    __m512d cy = _mm512_mul_pd(jp, _mm512_set1_pd(kSin60));
    __m512d dx = _mm512_sub_pd(x, cx), dy = _mm512_sub_pd(y, cy);
    __m512d hdx = _mm512_mul_pd(dx, _mm512_set1_pd(0.5));
    __m512d sdy = _mm512_mul_pd(dy, _mm512_set1_pd(kSin60));
    __m512d proj = _mm512_max_pd(
        _mm512_abs_pd(dx),
        _mm512_max_pd(_mm512_abs_pd(_mm512_add_pd(hdx, sdy)),
                      _mm512_abs_pd(_mm512_sub_pd(sdy, hdx))));
    __m512d margin = _mm512_sub_pd(_mm512_set1_pd(0.5), proj);
    redo |= _mm512_cmp_pd_mask(margin, _mm512_set1_pd(kHexMarginTol),
                               _CMP_LT_OQ);
  }
  *fallback = redo;

  __m512d p = _mm512_setzero_pd();
  for (int r = res; r >= 1; --r) {
    __m512d li = i, lj = j, lk = k, ci, cj, ck;
    if (r & 1) {
      vup_ap7(true, i, j, k);
      vlin3(T.down_ap7, i, j, k, ci, cj, ck);
    } else {
      vup_ap7(false, i, j, k);
      vlin3(T.down_ap7r, i, j, k, ci, cj, ck);
    }
    __m512d di = _mm512_sub_pd(li, ci), dj = _mm512_sub_pd(lj, cj),
            dk = _mm512_sub_pd(lk, ck);
    vnormalize(di, dj, dk);
    // digit = 4di + 2dj + dk in {0..6}; p |= digit << 3*(res-r), done
    // in f64 as p += digit * 8^(res-r) (p < 2^30: exact)
    __m512d digit = _mm512_add_pd(
        _mm512_add_pd(_mm512_mul_pd(_mm512_set1_pd(4.0), di),
                      _mm512_mul_pd(_mm512_set1_pd(2.0), dj)),
        dk);
    double pw = (double)(1ull << (3 * (res - r)));
    p = _mm512_add_pd(p, _mm512_mul_pd(digit, _mm512_set1_pd(pw)));
  }

  _mm256_storeu_si256((__m256i*)face_out, face32);
  _mm512_storeu_pd(p_out, p);
  _mm512_storeu_pd(i_out, i);
  _mm512_storeu_pd(j_out, j);
  _mm512_storeu_pd(k_out, k);
}

H3_TGT static void snap_avx512(const Tables& T, int res,
                               bool res_class_iii, const float* lat,
                               const float* lng, int64_t n, uint32_t* hi,
                               uint32_t* lo) {
  alignas(64) double pbuf[8], ibuf[8], jbuf[8], kbuf[8];
  alignas(32) int32_t faces[8];
  int64_t idx = 0;
  for (; idx + 8 <= n; idx += 8) {
    __mmask8 fallback = 0;
    snap_block8(T, res, res_class_iii, lat + idx, lng + idx, faces, pbuf,
                ibuf, jbuf, kbuf, &fallback);
    for (int t = 0; t < 8; ++t) {
      if ((fallback >> t) & 1) {
        // non-finite / out-of-range trig input, or a face-argmax /
        // hex-rounding decision inside the margin tolerance: the poly
        // trig may not reproduce libm's discrete outcome, so this lane
        // is redone scalar end-to-end — the bit-identical guarantee
        // holds by construction
        snap_one(T, res, res_class_iii, lat[idx + t], lng[idx + t],
                 &hi[idx + t], &lo[idx + t]);
        continue;
      }
      int face = faces[t];
      int64_t i = (int64_t)ibuf[t], j = (int64_t)jbuf[t],
              k = (int64_t)kbuf[t];
      // pentagon base cells take the deleted-subsequence branch; redo
      // those lanes scalar end-to-end (rare: 12 of 122 base cells)
      int64_t ic = i < 0 ? 0 : (i > 2 ? 2 : i);
      int64_t jc = j < 0 ? 0 : (j > 2 ? 2 : j);
      int64_t kc = k < 0 ? 0 : (k > 2 ? 2 : k);
      int flat = (int)(((face * 3 + ic) * 3 + jc) * 3 + kc);
      int bc = T.face_ijk_bc[flat];
      if (res > 0 && T.bc_pent[bc] != 0) {
        snap_one(T, res, res_class_iii, lat[idx + t], lng[idx + t],
                 &hi[idx + t], &lo[idx + t]);
        continue;
      }
      finish_cell(T, res, face, i, j, k, (uint32_t)pbuf[t], &hi[idx + t],
                  &lo[idx + t]);
    }
  }
  for (; idx < n; ++idx)
    snap_one(T, res, res_class_iii, lat[idx], lng[idx], &hi[idx],
             &lo[idx]);
}

static bool avx512_ok() {
  static const bool ok = __builtin_cpu_supports("avx512f") &&
                         __builtin_cpu_supports("avx512dq");
  return ok;
}

#endif  // H3_SNAP_AVX512

}  // namespace

extern "C" {

// lat/lng: float32 radians (n points); outputs hi/lo: uint32 halves of the
// 64-bit H3-compatible index.  Tables are the flat arrays of
// hexgrid.device._DeviceTables / _projection_bases, passed from Python.
void h3_snap_f32(
    const float* lat, const float* lng, int64_t n, int res,
    const double* face_xyz,     // (20,3)
    const double* u1,           // (20,3) — includes 1/RES0_U scale
    const double* u2,           // (20,3)
    double rot_cos, double rot_sin,  // Class III ap7 rotation
    double scale,               // sqrt(7)^res
    const int32_t* down_ap7,    // 9
    const int32_t* down_ap7r,   // 9
    const int32_t* face_ijk_bc,   // 540
    const int32_t* face_ijk_rot,  // 540
    const int32_t* bc_pent,       // 122
    const int32_t* pent_cw_off,   // 2440 = 122*20
    const int32_t* ccw_pow,       // 42 = 6*7
    int k_axes_digit,
    uint32_t* hi, uint32_t* lo) {
  const bool res_class_iii = (res & 1) != 0;
  const Tables T = {face_xyz, u1,  u2,          rot_cos,      rot_sin,
                    scale,    down_ap7, down_ap7r, face_ijk_bc,
                    face_ijk_rot, bc_pent, pent_cw_off, ccw_pow,
                    k_axes_digit};
#ifdef H3_SNAP_AVX512
  if (n >= 16 && avx512_ok()) {
    snap_avx512(T, res, res_class_iii, lat, lng, n, hi, lo);
    return;
  }
#endif
  for (int64_t idx = 0; idx < n; ++idx)
    snap_one(T, res, res_class_iii, lat[idx], lng[idx], &hi[idx],
             &lo[idx]);
}

// Scalar-only entry for differential tests: always takes the reference
// path regardless of CPU features.
void h3_snap_f32_scalar(
    const float* lat, const float* lng, int64_t n, int res,
    const double* face_xyz, const double* u1, const double* u2,
    double rot_cos, double rot_sin, double scale,
    const int32_t* down_ap7, const int32_t* down_ap7r,
    const int32_t* face_ijk_bc, const int32_t* face_ijk_rot,
    const int32_t* bc_pent, const int32_t* pent_cw_off,
    const int32_t* ccw_pow, int k_axes_digit,
    uint32_t* hi, uint32_t* lo) {
  const bool res_class_iii = (res & 1) != 0;
  const Tables T = {face_xyz, u1,  u2,          rot_cos,      rot_sin,
                    scale,    down_ap7, down_ap7r, face_ijk_bc,
                    face_ijk_rot, bc_pent, pent_cw_off, ccw_pow,
                    k_axes_digit};
  for (int64_t idx = 0; idx < n; ++idx)
    snap_one(T, res, res_class_iii, lat[idx], lng[idx], &hi[idx],
             &lo[idx]);
}

}  // extern "C"
