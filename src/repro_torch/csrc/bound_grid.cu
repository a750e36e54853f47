// Fused multi-level Eq. 4 bound grid for ExactHaus phases 0/1.
//
// Replaces: the Pallas kernel `_bound_grid_kernel` in
// src/repro/kernels/bound_matrix.py (launcher `bound_grid`, wrapper
// `repro.kernels.ops.bound_grid`).
//
// What it computes: for every (query b, corpus slot s) pair and every tree
// level [a, e) of the node range, LB[l, b, s] = max over occupied query
// nodes i of min over occupied corpus nodes j of lb(i, j), and the same for
// UB, with cd = |oq_i - od_j|, lb = max(cd - rd_j, 0) and
// ub = sqrt(cd^2 + rd_j^2) + rq_i (paper Eq. 4).  Unoccupied corpus nodes
// count as BIG, unoccupied query nodes as -BIG.  The arithmetic order is
// that of the plain version (repro_torch/kernels/ref.py
// frontier_bound_levels): squares accumulated in coordinate order, rd*rd as
// its own product, and the file is built with -fmad=false and IEEE sqrtf,
// so the result is bitwise equal to it.
//
// What bounds it on this card: at the main path's shape (B = 32 queries,
// S = 16384 slots, N = 15 nodes, W = 2) it reads ~3 MB of corpus nodes and
// writes 2 x 4 x 32 x 16384 floats (~17 MB), and needs 85 node pairs x 11
// FP32 operations per (b, s), plus a few per node: about 0.52 GFLOP
// against ~20 MB, so the FP32 rate bounds it (about 8 us), with memory
// close behind (about 6 us).
//
// Design: grid (B, ceil(S / 128)), one thread per (b, s).  Query b's N
// nodes (centers, radii, occupancy) are staged once per block in shared
// memory and read as broadcasts.  Each thread walks the levels and keeps
// only the running row min and column max in registers; the dense
// (N x N) bound tensor is never stored.  Reads of the (S, N, W) corpus
// layout are strided across a warp (neighbouring threads are N * W floats
// apart); coalescing them through shared memory is later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.4e38f;
constexpr int kMaxLevels = 32;
constexpr int kThreads = 128;

struct Levels {
  int n;
  int start[kMaxLevels];
  int stop[kMaxLevels];
};

__global__ void bound_grid_kernel(const float* __restrict__ oq,
                                  const float* __restrict__ rq,
                                  const uint8_t* __restrict__ q_ok,
                                  const float* __restrict__ od,
                                  const float* __restrict__ rd,
                                  const uint8_t* __restrict__ d_ok,
                                  Levels levels, int B, int S, int N, int W,
                                  float* __restrict__ LB,
                                  float* __restrict__ UB) {
  extern __shared__ float smem[];
  float* s_oq = smem;              // N * W query centers
  float* s_rq = s_oq + N * W;      // N query radii
  float* s_ok = s_rq + N;          // N query occupancy flags (0 / 1)
  const int b = blockIdx.x;
  for (int t = threadIdx.x; t < N * W; t += blockDim.x)
    s_oq[t] = oq[(size_t)b * N * W + t];
  for (int t = threadIdx.x; t < N; t += blockDim.x) {
    s_rq[t] = rq[(size_t)b * N + t];
    s_ok[t] = q_ok[(size_t)b * N + t] ? 1.0f : 0.0f;
  }
  __syncthreads();

  const int s = blockIdx.y * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const float* od_s = od + (size_t)s * N * W;
  const float* rd_s = rd + (size_t)s * N;
  const uint8_t* dok_s = d_ok + (size_t)s * N;

  for (int l = 0; l < levels.n; ++l) {
    const int a = levels.start[l];
    const int e = levels.stop[l];
    float lb_max = -INFINITY;
    float ub_max = -INFINITY;
    for (int i = a; i < e; ++i) {
      const float* qi = s_oq + i * W;
      const float rqi = s_rq[i];
      float row_lb = INFINITY;
      float row_ub = INFINITY;
      for (int j = a; j < e; ++j) {
        const float* dj = od_s + j * W;
        float diff = qi[0] - dj[0];
        float acc = diff * diff;
        for (int c = 1; c < W; ++c) {
          diff = qi[c] - dj[c];
          const float sq = diff * diff;
          acc = acc + sq;
        }
        const float cd = sqrtf(acc);
        const float rdj = rd_s[j];
        float lb = fmaxf(cd - rdj, 0.0f);
        const float rd2 = rdj * rdj;
        float ub = sqrtf(acc + rd2) + rqi;
        if (!dok_s[j]) {
          lb = kBig;
          ub = kBig;
        }
        row_lb = fminf(row_lb, lb);
        row_ub = fminf(row_ub, ub);
      }
      const bool ok = s_ok[i] != 0.0f;
      lb_max = fmaxf(lb_max, ok ? row_lb : -kBig);
      ub_max = fmaxf(ub_max, ok ? row_ub : -kBig);
    }
    const size_t o = ((size_t)l * B + b) * S + s;
    LB[o] = lb_max;
    UB[o] = ub_max;
  }
}

}  // namespace

// oq (B, N, W), rq / q_ok (B, N), od (S, N, W), rd / d_ok (S, N), all
// contiguous; level slices given as two host arrays of L ints.  Writes
// LB, UB (L, B, S).  Returns cudaGetLastError() after the launch.
extern "C" int bound_grid_launch(const float* oq, const float* rq,
                                 const uint8_t* q_ok, const float* od,
                                 const float* rd, const uint8_t* d_ok,
                                 const int* starts, const int* stops, int L,
                                 int B, int S, int N, int W, float* LB,
                                 float* UB, void* stream) {
  if (L < 1 || L > kMaxLevels || B < 1 || S < 1 || N < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  Levels levels;
  levels.n = L;
  for (int l = 0; l < L; ++l) {
    levels.start[l] = starts[l];
    levels.stop[l] = stops[l];
  }
  const size_t shmem = (size_t)N * (W + 2) * sizeof(float);
  const dim3 grid(B, (S + kThreads - 1) / kThreads);
  bound_grid_kernel<<<grid, kThreads, shmem, (cudaStream_t)stream>>>(
      oq, rq, q_ok, od, rd, d_ok, levels, B, S, N, W, LB, UB);
  return (int)cudaGetLastError();
}
