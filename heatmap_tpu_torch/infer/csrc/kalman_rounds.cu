// The Kalman rounds scan: K rounds of a constant-velocity predict and a
// Joseph-form update over M entities, in one launch.
//
// Replaces the JAX package's device program for the same function,
// heatmap_tpu/infer/kalman.py::_scan_fn (a jitted lax.scan over _round; an
// XLA program, not a Pallas kernel).  The plain PyTorch version is
// heatmap_tpu_torch/infer/kalman.py::filter_rounds_reference.
//
// Per entity the state is x = [pn, pe, vn, ve] and the covariance P, kept
// as its 10 unique entries (upper triangle, row-major).  Round r reads the
// entity's measurement z[r] (local metres), dt[r], valid[r] and reseed[r]
// and writes nis[r], tele[r], spd[r] and inn[r]; a chi-square gate on the
// NIS re-seeds the track at z instead of updating it.
//
// Design: one thread per entity.  The thread loads x and the upper
// triangle of P once (P is symmetrized on entry, as the reference's
// P[:, _IU, _JU]), keeps them in 14 registers through all K rounds, and
// writes x and the full symmetric P once at the end.  The (K, M) inputs and
// outputs are laid out round-major, so round r's loads and stores are
// coalesced across a warp (neighbouring entities, neighbouring addresses).
// K and M need no padding: the card does not recompile per shape.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s f32 outside the tensor
// cores; NVIDIA data sheet): each (round, entity) moves 31 bytes (z 8, dt 4,
// valid 1, reseed 1 in; nis 4, tele 1, spd 4, inn 8 out) and each entity
// 160 bytes of x and P in and out; each valid (round, entity) does 267 f32
// operations (counted term by term at chip_smoke.py's ROUND_OPS).  At the
// main path's shapes (~20,000 entities, tens of rounds) that is a few MB
// and well under a microsecond of either, so the kernel is bound by its
// launch and its memory latency, not by bytes or operations; chip_smoke.py
// computes the bound from each run's inputs.
//
// Rounding: built with -fmad=false and without --use_fast_math, so every
// product and sum rounds on its own and division is IEEE, in the
// reference's order of operations (e.g. q * dt3 / 3.0 is (q * dt3) / 3).
// The plain version runs the same ops one PyTorch kernel each, so the two
// agree bit for bit on the card.  hypotf is the function torch.hypot calls
// for float on CUDA.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

struct Consts {
  float q, r2, gate, p0_pos, p0_vel;
};

__device__ __forceinline__ float clamp_below(float v, float lo) {
  // jnp.maximum / torch.clamp_min: NaN stays NaN
  return v < lo ? lo : v;
}

__global__ void __launch_bounds__(kThreads)
kalman_rounds_kernel(const float4* __restrict__ x, const float* __restrict__ P,
                     const float2* __restrict__ z,
                     const float* __restrict__ dt,
                     const uint8_t* __restrict__ valid,
                     const uint8_t* __restrict__ reseed, int64_t k,
                     int64_t m, Consts c, float4* __restrict__ x_out,
                     float* __restrict__ P_out, float* __restrict__ nis_out,
                     uint8_t* __restrict__ tele_out,
                     float* __restrict__ spd_out,
                     float2* __restrict__ inn_out) {
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= m) return;
  const float4 x4 = x[e];
  float x0 = x4.x, x1 = x4.y, x2 = x4.z, x3 = x4.w;
  const float* pe = P + e * 16;
  float p00 = pe[0], p01 = pe[1], p02 = pe[2], p03 = pe[3];
  float p11 = pe[5], p12 = pe[6], p13 = pe[7];
  float p22 = pe[10], p23 = pe[11];
  float p33 = pe[15];
  const float q = c.q, r2 = c.r2;
  for (int64_t r = 0; r < k; ++r) {
    const int64_t i = r * m + e;
    const float2 zz = z[i];
    const bool v = valid[i] != 0;
    const bool rs = reseed[i] != 0;
    const float d = clamp_below(dt[i], 0.0f);
    const float dt2 = d * d, dt3 = d * d * d;
    // predict: F = I + dt on (0,2),(1,3); Pp = F P F^T + Q, white accel
    const float pp00 = p00 + d * (p02 + p02) + dt2 * p22 + q * dt3 / 3.0f;
    const float pp01 = p01 + d * p03 + d * p12 + dt2 * p23;
    const float pp02 = p02 + d * p22 + q * dt2 / 2.0f;
    const float pp03 = p03 + d * p23;
    const float pp11 = p11 + d * (p13 + p13) + dt2 * p33 + q * dt3 / 3.0f;
    const float pp12 = p12 + d * p23;
    const float pp13 = p13 + d * p33 + q * dt2 / 2.0f;
    const float pp22 = p22 + q * d;
    const float pp23 = p23;
    const float pp33 = p33 + q * d;
    const float xp0 = x0 + x2 * d;
    const float xp1 = x1 + x3 * d;
    // update (H = [I2 0]): the 2x2 innovation covariance by adjugate
    const float y0 = zz.x - xp0;
    const float y1 = zz.y - xp1;
    const float s00 = pp00 + r2, s01 = pp01, s11 = pp11 + r2;
    const float det = clamp_below(s00 * s11 - s01 * s01, 1e-12f);
    const float si00 = s11 / det, si01 = -s01 / det, si11 = s00 / det;
    const float nis = y0 * (si00 * y0 + si01 * y1)
                      + y1 * (si01 * y0 + si11 * y1);
    // gain K[i, :] = Pp[i, :2] @ Sinv
    const float pi0[4] = {pp00, pp01, pp02, pp03};
    const float pi1[4] = {pp01, pp11, pp12, pp13};
    float k0[4], k1[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      k0[a] = pi0[a] * si00 + pi1[a] * si01;
      k1[a] = pi0[a] * si01 + pi1[a] * si11;
    }
    const float xpv[4] = {xp0, xp1, x2, x3};
    float xu[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) xu[a] = xpv[a] + k0[a] * y0 + k1[a] * y1;
    // Joseph form Pu = (I-KH) Pp (I-KH)^T + r2 K K^T via B = (I-KH) Pp
    const float pm[4][4] = {{pp00, pp01, pp02, pp03},
                            {pp01, pp11, pp12, pp13},
                            {pp02, pp12, pp22, pp23},
                            {pp03, pp13, pp23, pp33}};
    float b[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[a][j] = pm[a][j] - k0[a] * pm[0][j] - k1[a] * pm[1][j];
    constexpr int IU[10] = {0, 0, 0, 0, 1, 1, 1, 2, 2, 3};
    constexpr int JU[10] = {0, 1, 2, 3, 1, 2, 3, 2, 3, 3};
    float pu[10];
#pragma unroll
    for (int u = 0; u < 10; ++u) {
      const int a = IU[u], j = JU[u];
      pu[u] = b[a][j] - b[a][0] * k0[j] - b[a][1] * k1[j]
              + r2 * (k0[a] * k0[j] + k1[a] * k1[j]);
    }
    // gate: an impossible innovation re-seeds instead of updating; an
    // explicit reseed (cross-shard handoff) takes precedence over the gate
    const bool tele = v && !rs && (nis > c.gate);
    const bool seed = v && (rs || tele);
    const bool ok = v && !rs && !tele;
    if (ok) {
      x0 = xu[0]; x1 = xu[1]; x2 = xu[2]; x3 = xu[3];
      p00 = pu[0]; p01 = pu[1]; p02 = pu[2]; p03 = pu[3]; p11 = pu[4];
      p12 = pu[5]; p13 = pu[6]; p22 = pu[7]; p23 = pu[8]; p33 = pu[9];
    } else if (seed) {
      x0 = zz.x; x1 = zz.y; x2 = 0.0f; x3 = 0.0f;
      p00 = c.p0_pos; p01 = 0.0f; p02 = 0.0f; p03 = 0.0f; p11 = c.p0_pos;
      p12 = 0.0f; p13 = 0.0f; p22 = c.p0_vel; p23 = 0.0f; p33 = c.p0_vel;
    }
    const bool upd = v && !rs;
    nis_out[i] = upd ? nis : 0.0f;
    inn_out[i] = upd ? make_float2(y0, y1) : make_float2(0.0f, 0.0f);
    tele_out[i] = tele ? 1 : 0;
    spd_out[i] = v ? hypotf(x2, x3) : 0.0f;
  }
  x_out[e] = make_float4(x0, x1, x2, x3);
  float* po = P_out + e * 16;
  po[0] = p00; po[1] = p01; po[2] = p02; po[3] = p03;
  po[4] = p01; po[5] = p11; po[6] = p12; po[7] = p13;
  po[8] = p02; po[9] = p12; po[10] = p22; po[11] = p23;
  po[12] = p03; po[13] = p13; po[14] = p23; po[15] = p33;
}

}  // namespace

// x (m,4) f32, P (m,4,4) f32, z (k,m,2) f32, dt (k,m) f32, valid and
// reseed (k,m) bytes of 0/1; outputs x_out (m,4), P_out (m,4,4), nis (k,m)
// f32, tele (k,m) bytes of 0/1, spd (k,m) f32, inn (k,m,2) f32.  Every
// array is contiguous on the device; x, x_out, z and inn are 16- or 8-byte
// aligned (as PyTorch allocates).  Returns the launch's cudaError_t (0 when
// the launch was accepted); cudaErrorInvalidValue for a negative k or m.
extern "C" int kalman_rounds_launch(const void* x, const void* P,
                                    const void* z, const void* dt,
                                    const void* valid, const void* reseed,
                                    int64_t k, int64_t m, float q, float r2,
                                    float gate, float p0_pos, float p0_vel,
                                    void* x_out, void* P_out, void* nis,
                                    void* tele, void* spd, void* inn,
                                    void* stream) {
  if (k < 0 || m < 0) return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  const Consts c = {q, r2, gate, p0_pos, p0_vel};
  const int64_t blocks = (m + kThreads - 1) / kThreads;
  kalman_rounds_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const float4*)x, (const float*)P, (const float2*)z, (const float*)dt,
      (const uint8_t*)valid, (const uint8_t*)reseed, k, m, c,
      (float4*)x_out, (float*)P_out, (float*)nis, (uint8_t*)tele,
      (float*)spd, (float2*)inn);
  return (int)cudaGetLastError();
}
