// H3 snap, whole: (lat, lng) f32 radians -> the H3 index words (hi, lo) of
// every point, res 0..10, in one launch.
//
// Replaces the TPU kernel heatmap_tpu/hexgrid/pallas_kernel.py::_snap_kernel
// (launched by _snap_geometry, wrapped by latlng_to_cell_pallas) together
// with the table stage that the JAX package leaves to XLA
// (heatmap_tpu/hexgrid/device.py::_apply_rotations_packed / _pack_packed).
// The plain PyTorch version is
// heatmap_tpu_torch/hexgrid/snap_kernel.py::latlng_to_cell_reference.
//
// Stages, per point, all in registers:
// 1. geometry: unit vector, best of 20 icosahedron faces, gnomonic
//    projection, Class III rotation at odd res, scale by sqrt(7)^res,
//    hex2d -> ijk, the exact aperture-7 digit chain packed 3 bits a digit;
// 2. tables: base cell and rotation count of (face, res-0 ijk), the digit
//    rotations into the base cell's home orientation (pentagons skip the
//    deleted K subsequence), then the 64-bit packing.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores; NVIDIA data sheet): each point reads 8 B and writes 8 B, so 2^19
// points move 8.4 MB, 2.5 us of memory time.  Each point does ~1,000
// operations at res 9 (chip_smoke.py::snap_ops counts them stage by stage:
// the digit chain ~730, the face search 120, the rotations ~60), 5.2e8 for
// 2^19 points, 7.8 us at 67 T op/s.  So the kernel is bound by operations,
// not bytes.  What the design does about it:
// - the face search carries the winning face's index only (strict d > best,
//   faces in order, so ties break as in the plain version) and reads the
//   winner's nine constants once from shared memory afterwards;
// - the kernel is instantiated per res, so the digit chain, the rotations
//   and the packing are unrolled with their shifts known at compile time;
// - the leading digit is one count-leading-zeros, not a walk of the fields;
// - the pentagon branch runs only for points whose base cell is a pentagon;
// - the aperture-7 rounding divides a biased numerator unsigned (a multiply
//   and a shift) instead of a signed floor division;
// - one sincosf per angle instead of a sinf and a cosf.
//
// Tables: the five lookup tables (3,684 entries, each fits a byte) arrive as
// one uint8 blob in device memory (layout below, built by
// snap_kernel.table_blob).  Each thread indexes them with its own face and
// base cell, which the constant cache would serialise, so every block copies
// the blob (and the 180 face constants) into shared memory once and then
// walks many points with a grid-stride loop; the grid is as many blocks as
// fit on the card at once.
//
// Rounding: built with -fmad=false and without --use_fast_math, so every
// product and sum rounds on its own, division is IEEE (not a reciprocal
// multiply) and sincosf is the accurate device function, whose sine and
// cosine are the words that sinf and cosf (which torch.sin / torch.cos
// call) give, as chip_smoke.py's word-for-word check shows.  That is what
// the plain version computes op by op; an FMA or __fdividef would move
// points that lie at cell edges.  The integer words are built in uint32,
// where every shift is defined.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// the blob: face_ijk_bc (20*27), face_ijk_rot (20*27), bc_pent (122),
// pent_cw_offset (122*20), ccw_pow (6*7), zero-padded to a multiple of 16 B
constexpr int kBcOff = 0;
constexpr int kRotOff = 540;
constexpr int kPentOff = 1080;
constexpr int kCwOff = 1202;
constexpr int kPowOff = 3642;
constexpr int kBlobBytes = 3696;

constexpr int kThreads = 256;
constexpr uint32_t kModeCell = 1;  // H3 index mode of a cell
constexpr int kKAxesDigit = 1;

struct FaceConsts {
  // per face: center xyz, tangent basis u1 xyz, tangent basis u2 xyz
  float c[20][9];
};

__device__ __forceinline__ int floordiv(int a, int b) {  // b > 0
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ void ijk_normalize(int& i, int& j, int& k) {
  int neg = min(i, 0);
  j -= neg; k -= neg; i -= neg;
  neg = min(j, 0);
  i -= neg; k -= neg; j -= neg;
  neg = min(k, 0);
  i -= neg; j -= neg; k -= neg;
  int m = min(min(i, j), k);
  i -= m; j -= m; k -= m;
}

__device__ __forceinline__ int div7_round(int x) {
  // floor((2x + 7) / 14) as an unsigned division of a biased numerator,
  // exact while |2x + 7| < 14 * 2^24.  At res <= 10 a point's hex-plane
  // coordinates are under ~2 res-0 units * sqrt(7)^10, so |2x + 7| stays
  // under 2^19.
  constexpr int kBias = 1 << 24;
  return (int)((uint32_t)(2 * x + 7 + 14 * kBias) / 14u) - kBias;
}

// one aperture-7 coarsening step (ccw for Class III, cw for Class II)
__device__ __forceinline__ void up_ap7(int& i, int& j, int& k, bool ccw) {
  int ii = i - k, jj = j - k;
  if (ccw) {
    i = div7_round(3 * ii - jj);
    j = div7_round(ii + 2 * jj);
  } else {
    i = div7_round(2 * ii + jj);
    j = div7_round(3 * jj - ii);
  }
  k = 0;
  ijk_normalize(i, j, k);
}

// the center of the finer cell under (i, j, k): down_ap7 / down_ap7r
__device__ __forceinline__ void down_ap7(int i, int j, int k, bool ccw,
                                         int& ci, int& cj, int& ck) {
  if (ccw) {  // images of i, j, k: (3,0,1), (1,3,0), (0,1,3)
    ci = 3 * i + 1 * j + 0 * k;
    cj = 0 * i + 3 * j + 1 * k;
    ck = 1 * i + 0 * j + 3 * k;
  } else {    // images of i, j, k: (3,1,0), (0,3,1), (1,0,3)
    ci = 3 * i + 0 * j + 1 * k;
    cj = 1 * i + 3 * j + 0 * k;
    ck = 0 * i + 1 * j + 3 * k;
  }
  ijk_normalize(ci, cj, ck);
}

__device__ __forceinline__ void hex2d_to_ijk(float x, float y,
                                             int& i, int& j, int& k) {
  const float kSin60 = (float)0.8660254037844386467637231707529361834714;
  const float kThird = (float)(1.0 / 3.0);
  const float kTwoThirds = (float)(2.0 * (1.0 / 3.0));
  float a1 = fabsf(x);
  float a2 = fabsf(y);
  float x2 = a2 / kSin60;
  float x1 = a1 + x2 * 0.5f;
  int m1 = (int)floorf(x1);
  int m2 = (int)floorf(x2);
  float r1 = x1 - (float)m1;
  float r2 = x2 - (float)m2;
  if (r1 < 0.5f) {
    if (r1 < kThird) {
      i = m1;
      j = (r2 < (1.0f + r1) * 0.5f) ? m2 : m2 + 1;
    } else {
      j = (r2 < (1.0f - r1)) ? m2 : m2 + 1;
      i = (((1.0f - r1) <= r2) && (r2 < 2.0f * r1)) ? m1 + 1 : m1;
    }
  } else {
    if (r1 < kTwoThirds) {
      j = (r2 < (1.0f - r1)) ? m2 : m2 + 1;
      i = (((2.0f * r1 - 1.0f) < r2) && (r2 < (1.0f - r1))) ? m1 : m1 + 1;
    } else {
      i = m1 + 1;
      j = (r2 < r1 * 0.5f) ? m2 : m2 + 1;
    }
  }
  // fold across the axes for negative x / y
  if (x < 0.0f) {
    if ((j % 2) == 0) {
      int diff = i - floordiv(j, 2);
      i = i - 2 * diff;
    } else {
      int diff = i - floordiv(j + 1, 2);
      i = i - (2 * diff + 1);
    }
  }
  if (y < 0.0f) {
    i = i - floordiv(2 * j + 1, 2);
    j = -j;
  }
  k = 0;
  ijk_normalize(i, j, k);
}

// highest nonzero 3-bit field of a packed chain (0 when p == 0)
__device__ __forceinline__ int lead_digit(uint32_t p) {
  int b = 31 - __clz((int)max(p, 1u));
  return (int)((p >> (3 * (b / 3))) & 7u);
}

// CCW^rot applied to each of the RES digit fields of p
template <int RES>
__device__ __forceinline__ uint32_t rot_fields(uint32_t p,
                                               const uint8_t* ccw_pow,
                                               int rot) {
  const uint8_t* row = ccw_pow + rot * 7;
  uint32_t out = 0;
#pragma unroll
  for (int f = 0; f < RES; ++f)
    out |= (uint32_t)row[(p >> (3 * f)) & 7u] << (3 * f);
  return out;
}

// the 64-bit filler of unused digits (7) below res, split into two words
template <int RES>
__host__ __device__ constexpr uint64_t filler() {
  uint64_t f = 0;
  for (int r = RES + 1; r < 16; ++r) f |= (uint64_t)7 << (3 * (15 - r));
  return f;
}

template <int RES>
__global__ void __launch_bounds__(kThreads)
snap_cell_kernel(const float* __restrict__ lat_in,
                 const float* __restrict__ lng_in, int64_t n, FaceConsts fc,
                 float cr, float sr, float scale,
                 const uint4* __restrict__ blob,
                 int32_t* __restrict__ hi_out, int32_t* __restrict__ lo_out) {
  __shared__ float s_face[20 * 9];
  __shared__ __align__(16) uint8_t s_tab[kBlobBytes];
  for (int q = threadIdx.x; q < kBlobBytes / 16; q += kThreads)
    reinterpret_cast<uint4*>(s_tab)[q] = blob[q];
  for (int q = threadIdx.x; q < 20 * 9; q += kThreads)
    s_face[q] = fc.c[q / 9][q % 9];
  __syncthreads();

  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x; t < n;
       t += stride) {
    float lat = lat_in[t];
    float lng = lng_in[t];
    float slat, clat, slng, clng;
    sincosf(lat, &slat, &clat);
    sincosf(lng, &slng, &clng);
    float vx = clat * clng;
    float vy = clat * slng;
    float vz = slat;

    // best of 20 faces by a strict d > best, faces in order: only the
    // winner's index rides along
    float best = -2.0f;
    int face = 0;
#pragma unroll
    for (int f = 0; f < 20; ++f) {
      float d = vx * fc.c[f][0] + vy * fc.c[f][1] + vz * fc.c[f][2];
      if (d > best) {
        best = d;
        face = f;
      }
    }
    const float* w = s_face + face * 9;

    // gnomonic projection onto the winning face's tangent plane (true
    // division, as the reference insists)
    float px = vx / best - w[0];
    float py = vy / best - w[1];
    float pz = vz / best - w[2];
    float x = px * w[3] + py * w[4] + pz * w[5];
    float y = px * w[6] + py * w[7] + pz * w[8];
    if (RES % 2 == 1) {  // Class III
      float xr = x * cr + y * sr;
      float yr = y * cr - x * sr;
      x = xr;
      y = yr;
    }
    x = x * scale;
    y = y * scale;

    // exact int aperture-7 digit chain, packed 3 bits a digit, the
    // coarsest digit in the top field
    int i, j, k;
    hex2d_to_ijk(x, y, i, j, k);
    uint32_t p = 0;
#pragma unroll
    for (int r = RES; r > 0; --r) {
      int li = i, lj = j, lk = k;
      bool ccw = (r % 2 == 1);
      up_ap7(i, j, k, ccw);
      int ci, cj, ck;
      down_ap7(i, j, k, ccw, ci, cj, ck);
      int di = li - ci, dj = lj - cj, dk = lk - ck;
      ijk_normalize(di, dj, dk);
      p |= (uint32_t)(4 * di + 2 * dj + dk) << (3 * (RES - r));
    }
    i = min(max(i, 0), 2);
    j = min(max(j, 0), 2);
    k = min(max(k, 0), 2);

    // base cell and its home-orientation rotations
    int flat = ((face * 3 + i) * 3 + j) * 3 + k;
    uint32_t bc = s_tab[kBcOff + flat];
    int rot = s_tab[kRotOff + flat];
    const uint8_t* ccw_pow = s_tab + kPowOff;
    if (s_tab[kPentOff + bc]) {
      // pentagon: rotate a leading K out of the deleted subsequence (cw
      // or ccw by the face), then rot pentagon ccw steps, each skipping K
      if (lead_digit(p) == kKAxesDigit)
        p = rot_fields<RES>(p, ccw_pow,
                            s_tab[kCwOff + bc * 20 + face] ? 5 : 1);
      for (int s = 0; s < rot; ++s) {
        p = rot_fields<RES>(p, ccw_pow, 1);
        if (lead_digit(p) == kKAxesDigit) p = rot_fields<RES>(p, ccw_pow, 1);
      }
    } else {
      p = rot_fields<RES>(p, ccw_pow, rot);
    }

    // pack: the digit block lands at bit 3*(15-res) of the 64-bit index
    constexpr int off = 3 * (15 - RES);
    uint32_t hi = (kModeCell << 27) | ((uint32_t)RES << 20) | (bc << 13);
    uint32_t lo = 0;
    if constexpr (RES > 0 && off >= 32) {
      hi |= p << (off - 32);
    } else if constexpr (RES > 0) {
      lo |= p << off;
      if constexpr (off + 3 * RES > 32) hi |= p >> (32 - off);
    }
    constexpr uint64_t fill = filler<RES>();
    hi |= (uint32_t)(fill >> 32);
    lo |= (uint32_t)(fill & 0xFFFFFFFFu);
    hi_out[t] = (int32_t)hi;
    lo_out[t] = (int32_t)lo;
  }
}

template <int RES>
int launch(const float* lat, const float* lng, int64_t n, const FaceConsts& fc,
           const float* rc, const uint4* blob, int sm_count, int32_t* hi,
           int32_t* lo, cudaStream_t stream) {
  static int blocks_per_sm = 0;  // resident blocks of this instance per SM
  if (blocks_per_sm == 0) {
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks_per_sm, snap_cell_kernel<RES>, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
  }
  int64_t blocks = (n + kThreads - 1) / kThreads;
  int64_t resident = (int64_t)sm_count * blocks_per_sm;
  if (blocks > resident) blocks = resident;
  snap_cell_kernel<RES><<<(unsigned)blocks, kThreads, 0, stream>>>(
      lat, lng, n, fc, rc[0], rc[1], rc[2], blob, hi, lo);
  return (int)cudaGetLastError();
}

}  // namespace

// consts: 20 x 9 face constants (row-major), then cr, sr, scale.
// tables: the uint8 blob in device memory, table_bytes long.
// Returns the launch's cudaError_t (0 when the launch was accepted);
// cudaErrorInvalidValue for a res outside 0..10 or a blob of the wrong size.
extern "C" int snap_cell_launch(const void* lat, const void* lng, int64_t n,
                                int res, const float* consts,
                                const void* tables, int64_t table_bytes,
                                int sm_count, void* hi, void* lo,
                                void* stream) {
  if (res < 0 || res > 10 || table_bytes != kBlobBytes || sm_count <= 0)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  FaceConsts fc;
  for (int f = 0; f < 20; ++f)
    for (int q = 0; q < 9; ++q) fc.c[f][q] = consts[f * 9 + q];
  const float* rc = consts + 180;
  auto a = (const float*)lat;
  auto b = (const float*)lng;
  auto t = (const uint4*)tables;
  auto h = (int32_t*)hi;
  auto l = (int32_t*)lo;
  auto s = (cudaStream_t)stream;
  switch (res) {
    case 0: return launch<0>(a, b, n, fc, rc, t, sm_count, h, l, s);
    case 1: return launch<1>(a, b, n, fc, rc, t, sm_count, h, l, s);
    case 2: return launch<2>(a, b, n, fc, rc, t, sm_count, h, l, s);
    case 3: return launch<3>(a, b, n, fc, rc, t, sm_count, h, l, s);
    case 4: return launch<4>(a, b, n, fc, rc, t, sm_count, h, l, s);
    case 5: return launch<5>(a, b, n, fc, rc, t, sm_count, h, l, s);
    case 6: return launch<6>(a, b, n, fc, rc, t, sm_count, h, l, s);
    case 7: return launch<7>(a, b, n, fc, rc, t, sm_count, h, l, s);
    case 8: return launch<8>(a, b, n, fc, rc, t, sm_count, h, l, s);
    case 9: return launch<9>(a, b, n, fc, rc, t, sm_count, h, l, s);
    default: return launch<10>(a, b, n, fc, rc, t, sm_count, h, l, s);
  }
}
