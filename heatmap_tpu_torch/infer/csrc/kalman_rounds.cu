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
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s f32 outside the tensor
// cores; NVIDIA data sheet): each (round, entity) moves 31 bytes (z 8, dt 4,
// valid 1, reseed 1 in; nis 4, tele 1, spd 4, inn 8 out) and each entity
// 160 bytes of x and P in and out, so 31*K*M + 160*M bytes; each valid
// (round, entity) does 267 f32 operations (counted term by term at
// infer/roundset.py's ROUND_OPS).  At the main path's K 27 x M 20,000
// that is 19.9 MB, 6 us of bytes; chip_smoke.py computes the bound from
// each run's inputs.
//
// What held the first design back (one thread an entity, each round's
// z, dt, valid and reseed loaded from device memory at the loop head): the
// trip count is a runtime value, so the compiler neither unrolls the loop
// nor hoists round r+1's loads above round r's arithmetic, and every round
// waited one full memory round trip.  At M = 20,000 its 157 blocks of 128
// threads put ~4.7 warps on an SM, far too few to hide that wait, so its
// time was ~K round trips (0.036 ms at K 27 against the 0.006 ms bound).
// Its reads and writes of P, 64 bytes apart from one thread to the next,
// were uncoalesced.
//
// This design: a block of kTile = 64 threads owns a tile of 64 entities
// (M = 20,000 makes 313 blocks, over two on each of an H100's 132 SMs) and
// walks them through the rounds in chunks of kRounds rounds, out of a ring of
// kStages stages in dynamic shared memory.  One thread starts TMA 2D loads
// of each chunk's z, dt, valid and reseed boxes, up to kStages chunks
// ahead, each stage completing on an mbarrier, so the loads are in flight
// while the threads run the rounds of the chunk before out of shared
// memory.  The tile's x and P come in by one TMA load each at the start and
// x' and P' go out by a TMA store at the end (whole rows of the tile, so
// the 64-byte stride costs nothing).  A chunk's outputs are staged in the
// stage's output boxes and written by TMA stores (a bulk group each chunk),
// which run while the next chunk computes.  Tails need no masks: a load
// zero-fills a box past K or M, and a zero lane (valid = reseed = 0) leaves
// x and P as they were and writes zeros, which a store clips at the
// tensor's bounds.  The tensor maps are encoded on the host at each launch.
//
// Row pitch: TMA takes global rows 16-byte aligned, so every (K, M) plane
// (z as a (K, 2*ld) f32 plane) has its rows ld entities apart, ld >= M a
// multiple of 16 (the byte planes need all 16); infer/kalman.py stages the
// planes so and hands the kernel [:, :M] views.
//
// Rounding: built with -fmad=false and without --use_fast_math, so every
// product and sum rounds on its own and division is IEEE, in the
// reference's order of operations (e.g. q * dt3 / 3.0 is (q * dt3) / 3).
// The plain version runs the same ops one PyTorch kernel each, so the two
// agree bit for bit on the card.  hypotf is the function torch.hypot calls
// for float on CUDA.

#include <cuda.h>  // CUtensorMap and its enums only: cuTensorMapEncodeTiled
                   // is looked up at run time, not linked
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;   // entities a block, one a thread
constexpr int kRounds = 8;  // rounds a chunk
constexpr int kStages = 4;  // chunks the ring holds

struct Consts {
  float q, r2, gate, p0_pos, p0_vel;
};

// one entity's state through the rounds
struct Track {
  float x0, x1, x2, x3;
  float p00, p01, p02, p03, p11, p12, p13, p22, p23, p33;
};

struct Maps {
  CUtensorMap z, dt, valid, reseed, x, P;         // loaded
  CUtensorMap x_out, P_out, nis, tele, spd, inn;  // stored
};

// Byte offsets in the dynamic shared memory: x and P of the tile, then
// kStages stages, each the chunk's input boxes and then its output boxes.
// Every box starts 128-byte aligned, as TMA requires.
struct Layout {
  static constexpr int T = kTile;
  static constexpr int kX = 0;
  static constexpr int kP = kX + T * 16;
  static constexpr int kStage0 = kP + T * 64;
  static constexpr int kZ = 0;
  static constexpr int kDt = kZ + kRounds * T * 8;
  static constexpr int kValid = kDt + kRounds * T * 4;
  static constexpr int kReseed = kValid + kRounds * T;
  static constexpr int kNis = kReseed + kRounds * T;
  static constexpr int kTele = kNis + kRounds * T * 4;
  static constexpr int kSpd = kTele + kRounds * T;
  static constexpr int kInn = kSpd + kRounds * T * 4;
  static constexpr int kStage = kInn + kRounds * T * 8;
  // the bytes each load completes on its mbarrier (whole boxes, zero
  // fill included)
  static constexpr uint32_t kChunkBytes = kRounds * T * 14;
  static constexpr uint32_t kStateBytes = T * 80;
  static_assert(kP % 128 == 0 && kStage0 % 128 == 0 && kDt % 128 == 0 &&
                    kValid % 128 == 0 && kReseed % 128 == 0 &&
                    kNis % 128 == 0 && kTele % 128 == 0 && kSpd % 128 == 0 &&
                    kInn % 128 == 0 && kStage % 128 == 0,
                "every box 128-byte aligned");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// at most N bulk groups still reading their shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// this thread's shared-memory writes, made visible to the TMA (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ float clamp_below(float v, float lo) {
  // jnp.maximum / torch.clamp_min: NaN stays NaN
  return v < lo ? lo : v;
}

// One round of one entity, the reference's _round.
__device__ __forceinline__ void round_step(Track& s, const float2 zz,
                                           const float dt, const bool v,
                                           const bool rs, const Consts& c,
                                           float* nis_out, uint8_t* tele_out,
                                           float* spd_out, float2* inn_out) {
  float &x0 = s.x0, &x1 = s.x1, &x2 = s.x2, &x3 = s.x3;
  float &p00 = s.p00, &p01 = s.p01, &p02 = s.p02, &p03 = s.p03;
  float &p11 = s.p11, &p12 = s.p12, &p13 = s.p13;
  float &p22 = s.p22, &p23 = s.p23, &p33 = s.p33;
  const float q = c.q, r2 = c.r2;
  const float d = clamp_below(dt, 0.0f);
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
  *nis_out = upd ? nis : 0.0f;
  *inn_out = upd ? make_float2(y0, y1) : make_float2(0.0f, 0.0f);
  *tele_out = tele ? 1 : 0;
  *spd_out = v ? hypotf(x2, x3) : 0.0f;
}

__device__ __forceinline__ void load_chunk(const Maps& maps,
                                           unsigned char* stage, int chunk,
                                           int e0, uint64_t* bar) {
  using L = Layout;
  const int r0 = chunk * kRounds;
  mbar_expect_tx(bar, L::kChunkBytes);
  tma_load(stage + L::kZ, &maps.z, 2 * e0, r0, bar);
  tma_load(stage + L::kDt, &maps.dt, e0, r0, bar);
  tma_load(stage + L::kValid, &maps.valid, e0, r0, bar);
  tma_load(stage + L::kReseed, &maps.reseed, e0, r0, bar);
}

__global__ void __launch_bounds__(kTile)
kalman_rounds_kernel(__grid_constant__ const Maps maps, const int k,
                     const Consts c) {
  using L = Layout;
  constexpr int T = kTile;
  extern __shared__ unsigned char smem_raw[];
  // [0, kStages): each stage's inputs have landed; [kStages]: x and P have
  __shared__ __align__(8) uint64_t bars[kStages + 1];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  const int t = threadIdx.x;
  const int e0 = blockIdx.x * T;
  const int chunks = (k + kRounds - 1) / kRounds;
  const bool leader = t == 0;
  if (leader) {
    for (int s = 0; s <= kStages; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (leader) {
    mbar_expect_tx(&bars[kStages], L::kStateBytes);
    tma_load(smem + L::kX, &maps.x, 0, e0, &bars[kStages]);
    tma_load(smem + L::kP, &maps.P, 0, e0, &bars[kStages]);
    for (int ch = 0; ch < chunks && ch < kStages; ++ch)
      load_chunk(maps, smem + L::kStage0 + ch * L::kStage, ch, e0,
                    &bars[ch]);
  }
  mbar_wait(&bars[kStages], 0);
  float* xs = reinterpret_cast<float*>(smem + L::kX) + 4 * t;
  float* ps = reinterpret_cast<float*>(smem + L::kP) + 16 * t;
  const float4 x4 = *reinterpret_cast<const float4*>(xs);
  // P symmetrized from its upper triangle, as the reference's P[:, _IU, _JU]
  Track s = {x4.x, x4.y, x4.z, x4.w, ps[0], ps[1], ps[2], ps[3], ps[5],
             ps[6], ps[7], ps[10], ps[11], ps[15]};
  for (int ch = 0; ch < chunks; ++ch) {
    const int st = ch % kStages;
    unsigned char* stage = smem + L::kStage0 + st * L::kStage;
    mbar_wait(&bars[st], (ch / kStages) & 1);
    const float2* z = reinterpret_cast<const float2*>(stage + L::kZ);
    const float* dt = reinterpret_cast<const float*>(stage + L::kDt);
    const uint8_t* valid = stage + L::kValid;
    const uint8_t* reseed = stage + L::kReseed;
    float* nis = reinterpret_cast<float*>(stage + L::kNis);
    uint8_t* tele = stage + L::kTele;
    float* spd = reinterpret_cast<float*>(stage + L::kSpd);
    float2* inn = reinterpret_cast<float2*>(stage + L::kInn);
    // the chunk's rows past K were zero-filled; nothing reads them and the
    // store clips them
    const int rounds = min(kRounds, k - ch * kRounds);
    for (int j = 0; j < rounds; ++j) {
      const int i = j * T + t;
      round_step(s, z[i], dt[i], valid[i] != 0, reseed[i] != 0, c, &nis[i],
                 &tele[i], &spd[i], &inn[i]);
    }
    fence_proxy_async();
    // the next chunk writes the output boxes that chunk ch + 1 - kStages
    // stored: that store has read them once at most kStages - 2 groups
    // (chunks ch + 2 - kStages .. ch - 1) are still reading
    if (leader) bulk_wait_read<kStages - 2>();
    __syncthreads();
    if (leader) {
      const int r0 = ch * kRounds;
      tma_store(&maps.nis, stage + L::kNis, e0, r0);
      tma_store(&maps.tele, stage + L::kTele, e0, r0);
      tma_store(&maps.spd, stage + L::kSpd, e0, r0);
      tma_store(&maps.inn, stage + L::kInn, 2 * e0, r0);
      bulk_commit();
      // every thread is past this stage's inputs: refill it
      if (ch + kStages < chunks)
        load_chunk(maps, stage, ch + kStages, e0, &bars[st]);
    }
  }
  // x' and P' (the full symmetric matrix) out through the tile's boxes
  *reinterpret_cast<float4*>(xs) = make_float4(s.x0, s.x1, s.x2, s.x3);
  ps[0] = s.p00; ps[1] = s.p01; ps[2] = s.p02; ps[3] = s.p03;
  ps[4] = s.p01; ps[5] = s.p11; ps[6] = s.p12; ps[7] = s.p13;
  ps[8] = s.p02; ps[9] = s.p12; ps[10] = s.p22; ps[11] = s.p23;
  ps[12] = s.p03; ps[13] = s.p13; ps[14] = s.p23; ps[15] = s.p33;
  fence_proxy_async();
  __syncthreads();
  if (leader) {
    tma_store(&maps.x_out, smem + L::kX, 0, e0);
    tma_store(&maps.P_out, smem + L::kP, 0, e0);
    bulk_commit();
    bulk_wait_all();  // the block's shared memory outlives every store
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime; a cudaError_t
int encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return (int)cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return 0;
}

// A 2D map of `rows` rows of `cols` elements, `row_bytes` apart, read and
// written in boxes of box_rows x box_cols; out-of-bounds loads read zeros.
CUresult encode(EncodeTiled fn, CUtensorMap* map, CUtensorMapDataType type,
                const void* base, uint64_t cols, uint64_t rows,
                uint64_t row_bytes, uint32_t box_cols, uint32_t box_rows) {
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Encode failures are returned negated (a CUresult is positive), so the
// caller tells them from a cudaError_t.
int launch(const void* const* in, void* const* out, int k, int m, int64_t ld,
           const Consts& c, cudaStream_t stream) {
  using L = Layout;
  constexpr int T = kTile;
  EncodeTiled fn;
  if (const int err = encoder(&fn)) return err;
  Maps maps;
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUtensorMapDataType u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  // planes (name, type, element bytes, elements an entity, base)
  struct Plane {
    CUtensorMap* map;
    CUtensorMapDataType type;
    int elem, width;
    const void* base;
  };
  const Plane planes[8] = {
      {&maps.z, f32, 4, 2, in[2]},     {&maps.dt, f32, 4, 1, in[3]},
      {&maps.valid, u8, 1, 1, in[4]},  {&maps.reseed, u8, 1, 1, in[5]},
      {&maps.nis, f32, 4, 1, out[2]},  {&maps.tele, u8, 1, 1, out[3]},
      {&maps.spd, f32, 4, 1, out[4]},  {&maps.inn, f32, 4, 2, out[5]}};
  for (const Plane& p : planes) {
    // K = 0: no round is read or written; the map only has to encode, so
    // it spans one 16-byte row of x
    const CUresult r =
        k > 0 ? encode(fn, p.map, p.type, p.base, (uint64_t)m * p.width,
                       (uint64_t)k, (uint64_t)ld * p.width * p.elem,
                       T * p.width, kRounds)
              : encode(fn, p.map, p.type, in[0], 16 / p.elem, 1, 16,
                       T * p.width, kRounds);
    if (r != CUDA_SUCCESS) return -(int)r;
  }
  const struct {
    CUtensorMap* map;
    const void* base;
    int width;
  } state[4] = {{&maps.x, in[0], 4},
                {&maps.P, in[1], 16},
                {&maps.x_out, out[0], 4},
                {&maps.P_out, out[1], 16}};
  for (const auto& p : state) {
    const CUresult r = encode(fn, p.map, f32, p.base, p.width, (uint64_t)m,
                              (uint64_t)p.width * 4, p.width, T);
    if (r != CUDA_SUCCESS) return -(int)r;
  }
  const int chunks = (k + kRounds - 1) / kRounds;
  const int stages = chunks < kStages ? chunks : kStages;
  // a ring only as deep as the chunks it holds, so short scans fit more
  // blocks an SM; 128 bytes for aligning the base
  const size_t smem = 128 + L::kStage0 + (size_t)stages * L::kStage;
  cudaError_t err = cudaFuncSetAttribute(
      kalman_rounds_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err == cudaSuccess)  // all of the SM's unified memory as shared
    err = cudaFuncSetAttribute(kalman_rounds_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((m + T - 1) / T);
  kalman_rounds_kernel<<<blocks, T, smem, stream>>>(maps, k, c);
  return (int)cudaGetLastError();
}

}  // namespace

// x (m,4) f32, P (m,4,4) f32, z (k,m,2) f32, dt (k,m) f32, valid and
// reseed (k,m) bytes of 0/1; outputs x_out (m,4), P_out (m,4,4), nis (k,m)
// f32, tele (k,m) bytes of 0/1, spd (k,m) f32, inn (k,m,2) f32.  x, P,
// x_out and P_out are contiguous; every (k,m) plane has its rows ld
// entities apart (z and inn 2*ld floats), ld >= m a multiple of 16, and
// every base is 16-byte aligned.  Returns
// 0 when the launch was accepted, a cudaError_t, or a failed tensor-map
// encode's CUresult negated; cudaErrorInvalidValue for a k, m or ld the
// kernel does not take.
extern "C" int kalman_rounds_launch(const void* x, const void* P,
                                    const void* z, const void* dt,
                                    const void* valid, const void* reseed,
                                    int64_t k, int64_t m, int64_t ld,
                                    float q, float r2, float gate,
                                    float p0_pos, float p0_vel, void* x_out,
                                    void* P_out, void* nis, void* tele,
                                    void* spd, void* inn, void* stream) {
  if (k < 0 || m < 0 || k > INT32_MAX || m > INT32_MAX / 2 || ld < m ||
      ld % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  const Consts c = {q, r2, gate, p0_pos, p0_vel};
  const void* const in[6] = {x, P, z, dt, valid, reseed};
  void* const out[6] = {x_out, P_out, nis, tele, spd, inn};
  return launch(in, out, (int)k, (int)m, ld, c, (cudaStream_t)stream);
}
