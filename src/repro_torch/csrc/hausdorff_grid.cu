// Directed Hausdorff distance for every (query, candidate) pair of an
// ExactHaus phase-2 chunk.
//
// Replaces: the Pallas kernel `_min_dist_grid_kernel` in
// src/repro/kernels/hausdorff.py (launcher `min_sq_dists_grid`) together
// with the epilogue of its wrapper `repro.kernels.ops.directed_hausdorff_grid`
// (min with BIG, sqrt, -BIG for invalid query rows, max over rows).
//
// What it computes: q (B, nq, W), ds (B, C, nd, W) with validity masks
// qv (B, nq), dv (B, C, nd) -> H (B, C) with
//   H[b, c] = max over rows i < nq of (qv[b, i] ? sqrt(min(m_i, BIG)) : -BIG),
//   m_i     = min over valid points j of sum_k (q[b, i, k] - ds[b, c, j, k])^2,
// m_i starting at BIG.  Squares are accumulated in coordinate order and the
// file is built with -fmad=false and IEEE sqrtf, so H is bitwise equal to
// the plain version (repro_torch/kernels/ops.py, slab loop).  Skipping an
// invalid D point is exact: it would contribute BIG, and m_i <= BIG always.
//
// What bounds it on this card: FP32 issue.  At the main path's chunk shape
// (B = 32, C = 32, nq = nd = 4096, W = 2) the padded work is 17 G point
// pairs at 3W FP32 operations each, against only ~35 MB of input, so the
// kernel sits far above the H100's ops:bytes ridge (~20 FP32 ops per byte).
// What this run's data needs is less: only valid query rows against valid
// points count, about 15 % of the padded pairs for T-Drive-sized sets.
//
// Design: one block per (b, c) pair, 256 threads.  Each thread owns
// kRows query rows (coordinates and running mins in registers); D is
// streamed through shared memory in tiles of 256 points, each point read
// once from device memory per row pass and then broadcast to every thread.
// A tile whose points are all invalid is skipped as a whole (valid points
// sit at the front of the tree order, so this drops most padding); invalid
// rows and ragged nq / nd are masked in the kernel, with no padding to tile
// multiples.  The per-pair epilogue ends in a warp-shuffle max.  Not done
// yet: skipping invalid query rows, and fusing the candidate gather
// (`d_pts_all[ids]`, ~34 MB per chunk) into the tile loads.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.4e38f;
constexpr int kThreads = 256;
constexpr int kTile = 256;

template <int W, int kRows>
__global__ void __launch_bounds__(kThreads)
hausdorff_grid_kernel(const float* __restrict__ q,
                      const uint8_t* __restrict__ qv,
                      const float* __restrict__ ds,
                      const uint8_t* __restrict__ dv, int C, int nq, int nd,
                      float* __restrict__ H) {
  __shared__ float s_d[kTile * W];
  __shared__ int s_dv[kTile];
  __shared__ float s_red[kThreads / 32];

  const int bc = blockIdx.x;
  const int b = bc / C;
  const float* qb = q + (size_t)b * nq * W;
  const uint8_t* qvb = qv + (size_t)b * nq;
  const float* d = ds + (size_t)bc * nd * W;
  const uint8_t* dvb = dv + (size_t)bc * nd;

  float hmax = -INFINITY;
  for (int base = 0; base < nq; base += kThreads * kRows) {
    float qr[kRows][W];
    float m[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = base + r * kThreads + threadIdx.x;
#pragma unroll
      for (int c = 0; c < W; ++c)
        qr[r][c] = row < nq ? qb[(size_t)row * W + c] : 0.0f;
      m[r] = kBig;
    }
    for (int t0 = 0; t0 < nd; t0 += kTile) {
      const int n = min(kTile, nd - t0);
      __syncthreads();  // the previous tile is no longer read
      int any = 0;
      for (int t = threadIdx.x; t < kTile; t += kThreads) {
        const int ok = t < n ? (int)dvb[t0 + t] : 0;
        s_dv[t] = ok;
        any |= ok;
        if (t < n) {
#pragma unroll
          for (int c = 0; c < W; ++c)
            s_d[t * W + c] = d[(size_t)(t0 + t) * W + c];
        }
      }
      if (!__syncthreads_or(any)) continue;
      for (int t = 0; t < n; ++t) {
        if (!s_dv[t]) continue;  // uniform across the block
        float dp[W];
#pragma unroll
        for (int c = 0; c < W; ++c) dp[c] = s_d[t * W + c];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float diff = qr[r][0] - dp[0];
          float acc = diff * diff;
#pragma unroll
          for (int c = 1; c < W; ++c) {
            diff = qr[r][c] - dp[c];
            const float sq = diff * diff;
            acc = acc + sq;
          }
          m[r] = fminf(m[r], acc);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = base + r * kThreads + threadIdx.x;
      if (row < nq) {
        const float h = sqrtf(fminf(m[r], kBig));
        hmax = fmaxf(hmax, qvb[row] ? h : -kBig);
      }
    }
  }

  for (int o = 16; o > 0; o >>= 1)
    hmax = fmaxf(hmax, __shfl_xor_sync(0xffffffffu, hmax, o));
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) s_red[warp] = hmax;
  __syncthreads();
  if (warp == 0) {
    float v = lane < kThreads / 32 ? s_red[lane] : -INFINITY;
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) H[bc] = v;
  }
}

template <int W, int kRows>
int launch(const float* q, const uint8_t* qv, const float* ds,
           const uint8_t* dv, int B, int C, int nq, int nd, float* H,
           cudaStream_t stream) {
  hausdorff_grid_kernel<W, kRows><<<B * C, kThreads, 0, stream>>>(
      q, qv, ds, dv, C, nq, nd, H);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, nq, W), qv (B, nq), ds (B, C, nd, W), dv (B, C, nd), all
// contiguous -> H (B, C).  W in 1..8.  Returns cudaGetLastError().
extern "C" int hausdorff_grid_launch(const float* q, const uint8_t* qv,
                                     const float* ds, const uint8_t* dv,
                                     int B, int C, int nq, int nd, int W,
                                     float* H, void* stream) {
  if (B < 1 || C < 1 || nq < 1 || nd < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (W) {
    case 1: return launch<1, 16>(q, qv, ds, dv, B, C, nq, nd, H, s);
    case 2: return launch<2, 16>(q, qv, ds, dv, B, C, nq, nd, H, s);
    case 3: return launch<3, 16>(q, qv, ds, dv, B, C, nq, nd, H, s);
    case 4: return launch<4, 8>(q, qv, ds, dv, B, C, nq, nd, H, s);
    case 5: return launch<5, 4>(q, qv, ds, dv, B, C, nq, nd, H, s);
    case 6: return launch<6, 4>(q, qv, ds, dv, B, C, nq, nd, H, s);
    case 7: return launch<7, 4>(q, qv, ds, dv, B, C, nq, nd, H, s);
    case 8: return launch<8, 4>(q, qv, ds, dv, B, C, nq, nd, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
