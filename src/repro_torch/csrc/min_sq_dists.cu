// Per-row minimum squared distance from one query set to each of P datasets.
//
// Replaces: the Pallas kernel `_min_dist_kernel` in
// src/repro/kernels/hausdorff.py (launcher `min_sq_dists`, wrapper
// `repro.kernels.ops.directed_hausdorff`), as the JAX package's ExactHaus
// oracle runs it: vmapped over a chunk of candidates in one jitted call
// (src/repro/core/search.py, `topk_hausdorff_host`, `eval_chunk`), which
// gives the Pallas grid a pair axis.  On the port's path it backs
// `topk_hausdorff_host`, the ExactHaus oracle: one launch per chunk.  It
// shares nothing with csrc/hausdorff_grid.cu, the phase-2 kernel that the
// oracle checks.
//
// What it computes: q (nq, W) shared by all pairs, qv (nq,) or null (every
// row valid), ds (P, nd, W), dsv (P, nd) ->
//   out[p, i] = min(BIG, min over valid j of sum_k (q[i, k] - ds[p, j, k])^2)
//               for a valid row i, and BIG for an invalid one,
// the squares accumulated in coordinate order; built with -fmad=false, so
// it is bitwise equal to the plain version (repro_torch/kernels/ref.py,
// `min_sq_dists_pairs`).  The wrapper `ops.directed_hausdorff_pairs` takes
// sqrt, the row mask and the max in torch, as
// `repro.kernels.ops.directed_hausdorff` does.  Every reordering below is
// exact: fminf returns an operand, so a minimum is the same bits in any
// order and over any split, and an invalid point, which could only
// contribute BIG, changes nothing when skipped.
//
// What bounds it on this card: FP32 issue.  W = 2 costs 6 FP32
// instructions per (row, point) pair (2 sub, 2 mul, 1 add, 1 min), and
// -fmad=false leaves no FMA to pair two of them: at most 128 per clock per
// SM.  One pair at (4096, 4096) padded holds ~18 M such operations over its
// valid rows and points (0.5 us at the FP32 peak), too little to fill 132
// SMs; a chunk of 32 pairs holds ~0.6 G.
//
// Design: the pair axis fills the card, and only valid work is done.  Of
// 4-16 warps x 2-8 rows a thread x 1-2 minima a row, 8 x 2 x 2 was among
// the fastest at the oracle's shape on an H100, and the fastest of those
// for one pair.
//  * Grid (P pairs, row blocks of kRowsPerBlock).  A block whose rows are
//    all invalid writes BIG and exits.
//  * Every warp of a block holds the block's rows (kRows per thread) and
//    scans its own share of D: each tile of kTile points is cut into one
//    segment per warp.  A warp compacts its segment to the valid points in
//    shared memory (ballot and prefix count) and runs over them with no
//    per-point branch; no barrier is needed until the end, where the
//    warps' row minima are combined.  So a block keeps kWarps warps busy
//    on 64 rows, and a chunk of 32 pairs puts tens of warps on each SM.
//    D's padded tail costs its mask bytes, no arithmetic.  The next
//    segment is loaded into registers while the current one is computed;
//    the points are read as shared-memory broadcasts.
//  * Each thread keeps kAcc running minima for each of its rows, over
//    interleaved points, combined at the end: kRows * kAcc independent
//    chains instead of one serial fminf chain per thread.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.4e38f;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 2;                          // query rows per thread
// rows per block, held by every warp; PAIR_ROWS_PER_BLOCK in
// repro_torch/kernels/hausdorff.py
constexpr int kRowsPerBlock = 32 * kRows;         // 64
constexpr int kAcc = 2;                           // minima per row
constexpr int kPer = 4;                           // points per thread per tile
constexpr int kSeg = kPer * 32;                   // one warp's tile segment
constexpr int kTile = kWarps * kSeg;              // 1024 points per tile

template <int W>
__global__ void __launch_bounds__(kThreads)
min_sq_dists_pairs_kernel(const float* __restrict__ q,
                          const uint8_t* __restrict__ qv,
                          const float* __restrict__ ds,
                          const uint8_t* __restrict__ dsv, int nq, int nd,
                          float* __restrict__ out) {
  __shared__ float s_d[kWarps][kSeg * W];         // each warp's segment
  __shared__ float s_part[kWarps][kRowsPerBlock]; // each warp's row minima

  const int p = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int base = blockIdx.y * kRowsPerBlock;
  float* o = out + (size_t)p * nq;

  float qr[kRows][W];
  bool any = false;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = base + r * 32 + lane;
    const bool rv = row < nq && (qv == nullptr || qv[row] != 0);
    any |= rv;
#pragma unroll
    for (int c = 0; c < W; ++c)
      qr[r][c] = rv ? q[(size_t)row * W + c] : 0.0f;
  }
  // every warp holds the same rows, so every warp takes this branch alike
  if (!__any_sync(0xffffffffu, any)) {
    if (warp == 0) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int row = base + r * 32 + lane;
        if (row < nq) o[row] = kBig;
      }
    }
    return;
  }

  float m[kRows][kAcc];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int a = 0; a < kAcc; ++a) m[r][a] = kBig;

  const float* d = ds + (size_t)p * nd * W;
  const uint8_t* dv = dsv + (size_t)p * nd;
  const unsigned below = (1u << lane) - 1u;
  float* seg = s_d[warp];

  // this thread's points of the warp's segment of the tile at t0
  float pr[kPer][W];
  bool ok[kPer];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = t0 + warp * kSeg + k * 32 + lane;
      ok[k] = j < nd && dv[j] != 0;
#pragma unroll
      for (int c = 0; c < W; ++c)
        pr[k][c] = ok[k] ? d[(size_t)j * W + c] : 0.0f;
    }
  };
  // one point against every row, into minimum a
  auto visit = [&](const float* sp, int a) {
    float dp[W];
#pragma unroll
    for (int c = 0; c < W; ++c) dp[c] = sp[c];
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
      m[r][a] = fminf(m[r][a], acc);
    }
  };

  fetch(0);
  for (int t0 = 0; t0 < nd; t0 += kTile) {
    // compact this warp's valid points into its segment
    int n = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const unsigned vote = __ballot_sync(0xffffffffu, ok[k]);
      if (ok[k]) {
        const int at = n + __popc(vote & below);
#pragma unroll
        for (int c = 0; c < W; ++c) seg[at * W + c] = pr[k][c];
      }
      n += __popc(vote);
    }
    __syncwarp();
    if (t0 + kTile < nd) fetch(t0 + kTile);
    int t = 0;
#pragma unroll 2
    for (; t + kAcc <= n; t += kAcc) {
#pragma unroll
      for (int a = 0; a < kAcc; ++a) visit(seg + (t + a) * W, a);
    }
    for (; t < n; ++t) visit(seg + t * W, 0);
    __syncwarp();  // the segment is read before it is written again
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float v = m[r][0];
#pragma unroll
    for (int a = 1; a < kAcc; ++a) v = fminf(v, m[r][a]);
    s_part[warp][r * 32 + lane] = v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kRowsPerBlock; i += kThreads) {
    const int row = base + i;
    if (row >= nq) continue;
    float v = s_part[0][i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v = fminf(v, s_part[w][i]);
    o[row] = (qv == nullptr || qv[row] != 0) ? v : kBig;
  }
}

template <int W>
int launch(const float* q, const uint8_t* qv, const float* ds,
           const uint8_t* dsv, int P, int nq, int nd, float* out,
           cudaStream_t stream) {
  const dim3 grid(P, (nq + kRowsPerBlock - 1) / kRowsPerBlock);
  min_sq_dists_pairs_kernel<W><<<grid, kThreads, 0, stream>>>(
      q, qv, ds, dsv, nq, nd, out);
  return (int)cudaGetLastError();
}

}  // namespace

// q (nq, W) f32, qv (nq,) bool or null, ds (P, nd, W) f32, dsv (P, nd)
// bool, all contiguous -> out (P, nq) f32.  W in 1..8.  Returns
// cudaGetLastError() after the launch.
extern "C" int min_sq_dists_pairs_launch(const float* q, const uint8_t* qv,
                                         const float* ds, const uint8_t* dsv,
                                         int P, int nq, int nd, int W,
                                         float* out, void* stream) {
  if (P < 1 || nq < 1 || nd < 1 || nq > 65535 * kRowsPerBlock)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (W) {
#define CASE(w) \
    case w: return launch<w>(q, qv, ds, dsv, P, nq, nd, out, s);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
