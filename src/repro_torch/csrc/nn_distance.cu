// Per-point nearest neighbour: distance and index of the closest valid
// point of D for every point of Q.
//
// Replaces: the Pallas kernel `_nn_kernel` in src/repro/kernels/nn_distance.py
// (launcher `nn_sq_dists`, wrapper `repro.kernels.ops.nn_distance`, whose
// sqrt and query mask are fused here).  On the port's path it backs
// `point_search.nnp`, the unpruned NNP that the engine's pruned NNP is held
// to.
//
// What it computes: q (nq, W), d (nd, W), qv (nq,), dv (nd,) ->
//   m[i]    = min over j of v(i, j), v = sum_k (q[i,k] - d[j,k])^2 for a
//             valid j and BIG for an invalid one (squares added in
//             coordinate order),
//   idx[i]  = the first j that attains m[i],
//   dist[i] = sqrtf(m[i]); an invalid query row gets dist 0 and idx -1.
// Built with -fmad=false and IEEE sqrtf, in the plain version's order
// (repro_torch/kernels/ref.py nn_distance: masked distances, argmin,
// sqrt), so both outputs are bitwise equal to it.
//
// What bounds it on this card: FP32 issue.  At (4096, 4096), W = 2, it does
// 16.8 M pairs x 6 operations against 82 KB of input: ~1.5 us at the FP32
// peak.  One call fills 32 blocks of 132 SMs, so launch latency and the
// serial scan of each thread are what a caller sees.
//
// Design: one thread per query row, 128 rows per block.  D is streamed
// through shared memory in tiles of 128 points and read as broadcasts.
// Each thread scans j in ascending order with a strict `<`, so the first
// index wins ties without any cross-thread combine.  A tile whose points
// are all invalid contributes BIG at its first index, which matters only
// while the running minimum is still above BIG; otherwise it is skipped.
// Ragged nq / nd are masked.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.4e38f;
constexpr int kThreads = 128;

template <int W>
__global__ void __launch_bounds__(kThreads)
nn_distance_kernel(const float* __restrict__ q, const float* __restrict__ d,
                   const uint8_t* __restrict__ qv,
                   const uint8_t* __restrict__ dv, int nq, int nd,
                   float* __restrict__ dist, int32_t* __restrict__ idx) {
  __shared__ float s_d[kThreads * W];
  __shared__ int s_dv[kThreads];
  const int row = blockIdx.x * kThreads + threadIdx.x;
  float qr[W];
#pragma unroll
  for (int c = 0; c < W; ++c) qr[c] = row < nq ? q[(size_t)row * W + c] : 0.0f;
  float m = INFINITY;
  int mi = 0;
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
    if (!__syncthreads_or(ok)) {
      if (kBig < m) {  // the tile's first point, at BIG
        m = kBig;
        mi = t0;
      }
      continue;
    }
    for (int j = 0; j < n; ++j) {
      float v = kBig;
      if (s_dv[j]) {  // uniform across the block
        float diff = qr[0] - s_d[j * W];
        float acc = diff * diff;
#pragma unroll
        for (int c = 1; c < W; ++c) {
          diff = qr[c] - s_d[j * W + c];
          const float sq = diff * diff;
          acc = acc + sq;
        }
        v = acc;
      }
      if (v < m) {
        m = v;
        mi = t0 + j;
      }
    }
  }
  if (row < nq) {
    const bool ok = qv[row] != 0;
    dist[row] = ok ? sqrtf(m) : 0.0f;
    idx[row] = ok ? mi : -1;
  }
}

template <int W>
int launch(const float* q, const float* d, const uint8_t* qv,
           const uint8_t* dv, int nq, int nd, float* dist, int32_t* idx,
           cudaStream_t stream) {
  const int blocks = (nq + kThreads - 1) / kThreads;
  nn_distance_kernel<W><<<blocks, kThreads, 0, stream>>>(q, d, qv, dv, nq,
                                                         nd, dist, idx);
  return (int)cudaGetLastError();
}

}  // namespace

// q (nq, W), d (nd, W), qv (nq,), dv (nd,), all contiguous -> dist (nq,)
// float32, idx (nq,) int32.  W in 1..8.  Returns cudaGetLastError() after
// the launch.
extern "C" int nn_distance_launch(const float* q, const float* d,
                                  const uint8_t* qv, const uint8_t* dv,
                                  int nq, int nd, int W, float* dist,
                                  int32_t* idx, void* stream) {
  if (nq < 1 || nd < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (W) {
    case 1: return launch<1>(q, d, qv, dv, nq, nd, dist, idx, s);
    case 2: return launch<2>(q, d, qv, dv, nq, nd, dist, idx, s);
    case 3: return launch<3>(q, d, qv, dv, nq, nd, dist, idx, s);
    case 4: return launch<4>(q, d, qv, dv, nq, nd, dist, idx, s);
    case 5: return launch<5>(q, d, qv, dv, nq, nd, dist, idx, s);
    case 6: return launch<6>(q, d, qv, dv, nq, nd, dist, idx, s);
    case 7: return launch<7>(q, d, qv, dv, nq, nd, dist, idx, s);
    case 8: return launch<8>(q, d, qv, dv, nq, nd, dist, idx, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
