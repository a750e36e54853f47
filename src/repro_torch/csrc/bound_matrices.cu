// Eq. 4 bound matrices between two node frontiers, for a batch of pairs.
//
// Replaces: the Pallas kernel `_bound_kernel` in
// src/repro/kernels/bound_matrix.py (launcher `bound_matrices`, wrapper
// `repro.kernels.ops.bound_matrices`).  On the port's path it gives the
// leaf-level bounds of the engine's tree-pruned NNP (`nnp_pruned_core`),
// one launch for every (query, dataset) pair of a dispatch.
//
// What it computes: oq (P, nq, W), rq (P, nq), od (P, nd, W), rd (P, nd) ->
//   cd2 = sum_k (oq[p,i,k] - od[p,j,k])^2   (squares in coordinate order)
//   lb[p,i,j] = max(sqrtf(cd2) - rd[p,j], 0)
//   ub[p,i,j] = sqrtf(cd2 + rd[p,j] * rd[p,j]) + rq[p,i]
// (paper Eq. 4), with rd*rd its own product as in the plain version
// (repro_torch/kernels/ref.py bound_matrix).  Built with -fmad=false and
// IEEE sqrtf, so both outputs are bitwise equal to it.
//
// What bounds it on this card: memory.  At the main path's shape
// (P = 128: 80 (query, winner) pairs padded to their bucket, nq = nd = 256
// leaves, W = 2) it writes 2 x 8.4 M floats (67 MB) against 11 FP32
// operations per node pair (92 M in all): about 20 us of bytes against
// 1.4 us of FP32 issue.  Its one caller keeps only ub; lb is half the
// bytes.
//
// Design: grid (ceil(nd / 128), nq, P), one thread per (p, i, j).  The
// query node (p, i) is the same address across the block (a broadcast
// load); neighbouring threads read neighbouring corpus nodes and write
// neighbouring outputs, so the stores, which are the bound, are coalesced.
// The ragged nd edge is masked; nothing is padded.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <int W>
__global__ void __launch_bounds__(kThreads)
bound_matrices_kernel(const float* __restrict__ oq,
                      const float* __restrict__ rq,
                      const float* __restrict__ od,
                      const float* __restrict__ rd, int nq, int nd,
                      float* __restrict__ lb, float* __restrict__ ub) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const int i = blockIdx.y;
  const size_t p = blockIdx.z;
  if (j >= nd) return;
  const float* qi = oq + (p * nq + i) * W;
  const float* dj = od + (p * nd + j) * W;
  float diff = qi[0] - dj[0];
  float acc = diff * diff;
#pragma unroll
  for (int c = 1; c < W; ++c) {
    diff = qi[c] - dj[c];
    const float sq = diff * diff;
    acc = acc + sq;
  }
  const float rdj = rd[p * nd + j];
  const float cd = sqrtf(acc);
  const float rd2 = rdj * rdj;
  const size_t o = (p * nq + i) * nd + j;
  lb[o] = fmaxf(cd - rdj, 0.0f);
  ub[o] = sqrtf(acc + rd2) + rq[p * nq + i];
}

template <int W>
int launch(const float* oq, const float* rq, const float* od, const float* rd,
           int P, int nq, int nd, float* lb, float* ub, cudaStream_t stream) {
  const dim3 grid((nd + kThreads - 1) / kThreads, nq, P);
  bound_matrices_kernel<W><<<grid, kThreads, 0, stream>>>(oq, rq, od, rd, nq,
                                                          nd, lb, ub);
  return (int)cudaGetLastError();
}

}  // namespace

// oq (P, nq, W), rq (P, nq), od (P, nd, W), rd (P, nd), all contiguous ->
// lb, ub (P, nq, nd).  W in 1..8; nq and P at most 65535 (grid limits).
// Returns cudaGetLastError() after the launch.
extern "C" int bound_matrices_launch(const float* oq, const float* rq,
                                     const float* od, const float* rd, int P,
                                     int nq, int nd, int W, float* lb,
                                     float* ub, void* stream) {
  if (P < 1 || nq < 1 || nd < 1 || P > 65535 || nq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (W) {
    case 1: return launch<1>(oq, rq, od, rd, P, nq, nd, lb, ub, s);
    case 2: return launch<2>(oq, rq, od, rd, P, nq, nd, lb, ub, s);
    case 3: return launch<3>(oq, rq, od, rd, P, nq, nd, lb, ub, s);
    case 4: return launch<4>(oq, rq, od, rd, P, nq, nd, lb, ub, s);
    case 5: return launch<5>(oq, rq, od, rd, P, nq, nd, lb, ub, s);
    case 6: return launch<6>(oq, rq, od, rd, P, nq, nd, lb, ub, s);
    case 7: return launch<7>(oq, rq, od, rd, P, nq, nd, lb, ub, s);
    case 8: return launch<8>(oq, rq, od, rd, P, nq, nd, lb, ub, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
