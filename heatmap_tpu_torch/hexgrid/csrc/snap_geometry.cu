// H3 snap, geometry stage: (lat, lng) radians -> (face, flat27, packed
// aperture-7 digits) for every point, res 0..10.
//
// Replaces the TPU kernel heatmap_tpu/hexgrid/pallas_kernel.py::_snap_kernel
// (launched by _snap_geometry, wrapped by latlng_to_cell_pallas).  The plain
// PyTorch version of the same arithmetic is
// heatmap_tpu_torch/hexgrid/snap_kernel.py::snap_geometry_reference; the
// table stage that follows stays in PyTorch ops (hexgrid/device.py).
//
// Design: one thread per point over flat lanes, the ragged tail masked; no
// padding and no (64, 128) tiling.  Every intermediate (9 floats and a dozen
// ints a point) stays in registers.  The 20 faces' nine f32 constants ride
// in a by-value kernel parameter, i.e. the constant bank: every thread of a
// warp reads the same word, which the constant cache broadcasts.
//
// Rounding: built with -fmad=false and without --use_fast_math, so every
// product and sum rounds on its own, division is IEEE (not a reciprocal
// multiply) and cosf/sinf are the accurate device functions.  That is what
// the plain version computes op by op; an FMA or __fdividef would move
// points that lie at cell edges.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor cores;
// NVIDIA data sheet): each point reads 8 B and writes 12 B, 20 B in all, so
// 2^19 points move 10.5 MB: 3.1 us of memory time.  Each point does about
// 20 x (3 mul + 2 add + compare + 10 selects) = 320 operations in the face
// search, 3 divides, 9 mul/add in the projection, a sincos pair and a cos,
// and res rounds of ~60 integer operations in the digit chain: ~1,000
// operations at res 9, 5.2e8 for 2^19 points, 7.8 us at 67 T op/s.  So the
// kernel is bound by operations, not bytes: the face search and digit chain
// are ~95% of them.  Simple first: no attempt is made to fuse the table
// stage or to cut the select chain.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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
  return floordiv(2 * x + 7, 14);
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

__global__ void snap_geometry_kernel(const float* __restrict__ lat_in,
                                     const float* __restrict__ lng_in,
                                     int64_t n, int res, FaceConsts fc,
                                     float cr, float sr, float scale,
                                     int32_t* __restrict__ face_out,
                                     int32_t* __restrict__ flat_out,
                                     int32_t* __restrict__ p_out) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  float lat = lat_in[t];
  float lng = lng_in[t];
  float clat = cosf(lat);
  float vx = clat * cosf(lng);
  float vy = clat * sinf(lng);
  float vz = sinf(lat);

  // best of 20 faces by a strict d > best; the winner's bases ride along
  float best = -2.0f;
  int face = 0;
  float acc[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) acc[q] = 0.0f;
#pragma unroll
  for (int f = 0; f < 20; ++f) {
    float d = vx * fc.c[f][0] + vy * fc.c[f][1] + vz * fc.c[f][2];
    bool m = d > best;
    best = m ? d : best;
    face = m ? f : face;
#pragma unroll
    for (int q = 0; q < 9; ++q) acc[q] = m ? fc.c[f][q] : acc[q];
  }

  // gnomonic projection onto the winning face's tangent plane (true
  // division, as the reference insists)
  float px = vx / best - acc[0];
  float py = vy / best - acc[1];
  float pz = vz / best - acc[2];
  float x = px * acc[3] + py * acc[4] + pz * acc[5];
  float y = px * acc[6] + py * acc[7] + pz * acc[8];
  if (res % 2 == 1) {  // Class III
    float xr = x * cr + y * sr;
    float yr = y * cr - x * sr;
    x = xr;
    y = yr;
  }
  x = x * scale;
  y = y * scale;

  // exact int aperture-7 digit chain, packed 3 bits a digit
  int i, j, k;
  hex2d_to_ijk(x, y, i, j, k);
  int p = 0;
  for (int r = res; r > 0; --r) {
    int li = i, lj = j, lk = k;
    bool ccw = (r % 2 == 1);
    up_ap7(i, j, k, ccw);
    int ci, cj, ck;
    down_ap7(i, j, k, ccw, ci, cj, ck);
    int di = li - ci, dj = lj - cj, dk = lk - ck;
    ijk_normalize(di, dj, dk);
    p |= (4 * di + 2 * dj + dk) << (3 * (res - r));
  }
  i = min(max(i, 0), 2);
  j = min(max(j, 0), 2);
  k = min(max(k, 0), 2);
  face_out[t] = face;
  flat_out[t] = ((face * 3 + i) * 3 + j) * 3 + k;
  p_out[t] = p;
}

}  // namespace

// consts: 20 x 9 face constants (row-major), then cr, sr, scale.
// Returns the launch's cudaError_t (0 when the launch was accepted).
extern "C" int snap_geometry_launch(const void* lat, const void* lng,
                                    int64_t n, int res, const float* consts,
                                    void* face, void* flat, void* p,
                                    void* stream) {
  if (n <= 0) return 0;
  FaceConsts fc;
  for (int f = 0; f < 20; ++f)
    for (int q = 0; q < 9; ++q) fc.c[f][q] = consts[f * 9 + q];
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  snap_geometry_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
      (const float*)lat, (const float*)lng, n, res, fc, consts[180],
      consts[181], consts[182], (int32_t*)face, (int32_t*)flat,
      (int32_t*)p);
  return (int)cudaGetLastError();
}
