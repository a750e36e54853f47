// Per-row minimum squared distance from one query set to one dataset.
//
// Replaces: the Pallas kernel `_min_dist_kernel` in
// src/repro/kernels/hausdorff.py (launcher `min_sq_dists`, wrapper
// `repro.kernels.ops.directed_hausdorff`).  On the port's path it backs
// `topk_hausdorff_host`, the ExactHaus oracle.
//
// What it computes: q (nq, W), d (nd, W), dv (nd,) ->
//   out[i] = min over valid j of sum_k (q[i, k] - d[j, k])^2, starting at BIG,
// the squares accumulated in coordinate order; built with -fmad=false, so
// it is bitwise equal to the plain version (repro_torch/kernels/ref.py).
// The wrapper applies min(., BIG), sqrt, the query mask and the max in
// torch, as `repro.kernels.ops.directed_hausdorff` does.
//
// What bounds it on this card: FP32 issue.  At (4096, 4096), W = 2, it does
// 16.8 M pairs x 6 operations against 65 KB of input: ~1.5 us at the FP32
// peak.  One call is far too small to fill 132 SMs, so launch latency is
// what a caller sees.
//
// Design: one thread per query row, 128 rows per block; D is streamed
// through shared memory in tiles of 128 points and read as broadcasts; a
// tile whose points are all invalid is skipped.  Ragged nq / nd are masked.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.4e38f;
constexpr int kThreads = 128;

template <int W>
__global__ void __launch_bounds__(kThreads)
min_sq_dists_kernel(const float* __restrict__ q, const float* __restrict__ d,
                    const uint8_t* __restrict__ dv, int nq, int nd,
                    float* __restrict__ out) {
  __shared__ float s_d[kThreads * W];
  __shared__ int s_dv[kThreads];
  const int row = blockIdx.x * kThreads + threadIdx.x;
  float qr[W];
#pragma unroll
  for (int c = 0; c < W; ++c) qr[c] = row < nq ? q[(size_t)row * W + c] : 0.0f;
  float m = kBig;
  for (int t0 = 0; t0 < nd; t0 += kThreads) {
    const int n = min(kThreads, nd - t0);
    __syncthreads();  // the previous tile is no longer read
    const int t = threadIdx.x;
    const int ok = t < n ? (int)dv[t0 + t] : 0;
    s_dv[t] = ok;
    if (t < n) {
#pragma unroll
      for (int c = 0; c < W; ++c) s_d[t * W + c] = d[(size_t)(t0 + t) * W + c];
    }
    if (!__syncthreads_or(ok)) continue;
    for (int j = 0; j < n; ++j) {
      if (!s_dv[j]) continue;  // uniform across the block
      float diff = qr[0] - s_d[j * W];
      float acc = diff * diff;
#pragma unroll
      for (int c = 1; c < W; ++c) {
        diff = qr[c] - s_d[j * W + c];
        const float sq = diff * diff;
        acc = acc + sq;
      }
      m = fminf(m, acc);
    }
  }
  if (row < nq) out[row] = m;
}

template <int W>
int launch(const float* q, const float* d, const uint8_t* dv, int nq, int nd,
           float* out, cudaStream_t stream) {
  const int blocks = (nq + kThreads - 1) / kThreads;
  min_sq_dists_kernel<W><<<blocks, kThreads, 0, stream>>>(q, d, dv, nq, nd,
                                                          out);
  return (int)cudaGetLastError();
}

}  // namespace

// q (nq, W), d (nd, W), dv (nd,), all contiguous -> out (nq,).  W in 1..8.
// Returns cudaGetLastError() after the launch.
extern "C" int min_sq_dists_launch(const float* q, const float* d,
                                   const uint8_t* dv, int nq, int nd, int W,
                                   float* out, void* stream) {
  if (nq < 1 || nd < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (W) {
    case 1: return launch<1>(q, d, dv, nq, nd, out, s);
    case 2: return launch<2>(q, d, dv, nq, nd, out, s);
    case 3: return launch<3>(q, d, dv, nq, nd, out, s);
    case 4: return launch<4>(q, d, dv, nq, nd, out, s);
    case 5: return launch<5>(q, d, dv, nq, nd, out, s);
    case 6: return launch<6>(q, d, dv, nq, nd, out, s);
    case 7: return launch<7>(q, d, dv, nq, nd, out, s);
    case 8: return launch<8>(q, d, dv, nq, nd, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
