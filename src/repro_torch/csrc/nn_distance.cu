// Per-point nearest neighbour for P (query, dataset) pairs: distance and
// index of the closest valid point of D_p for every point of Q_p.
//
// Replaces: the Pallas kernel `_nn_kernel` in src/repro/kernels/nn_distance.py
// (launcher `nn_sq_dists`, wrappers `repro.kernels.ops.nn_distance` and
// `repro.kernels.ops.nn_distance_batched`, the latter a vmap that gives
// the Pallas grid a pair axis; their sqrt and query mask are fused here).
// On the port's path it backs `point_search.nnp` and `nnp_batched`, the
// unpruned NNP that the engine's pruned NNP is held to: one launch for
// every pair of a check.
//
// What it computes: qs (P, nq, W), qsv (P, nq), ds (P, nd, W), dsv (P, nd)
// -> for each pair p and row i, with v(j) = sum_k (qs[p,i,k] - ds[p,j,k])^2
// for a valid j and BIG for an invalid one (squares added in coordinate
// order):
//   m        = min over j of v(j),
//   idx[p,i] = the first j that attains m,
//   dist[p,i] = sqrtf(m); an invalid query row gets dist 0 and idx -1.
// Built with -fmad=false and IEEE sqrtf, so both outputs are bitwise equal
// to the plain version (repro_torch/kernels/ref.py `nn_distance`: masked
// distances, argmin, sqrt).
//
// What bounds it on this card: FP32 issue.  W = 2 costs 6 FP32
// instructions per (row, point) pair (2 sub, 2 mul, 1 add, 1 compare) and
// a root per valid row; -fmad=false leaves no FMA.  One pair at (4096,
// 4096) padded holds ~44 M operations over its valid rows and points (1.3
// us at the FP32 peak), too little to fill 132 SMs.
//
// Design: the pair axis fills the card, and only valid work is done.  Of
// 4-16 warps x 2-8 rows a thread x 1-2 minima a row, 8 x 2 x 2 was among
// the fastest at the NNP check's shape on an H100, and the fastest of
// those for one pair.
//  * Grid (P pairs, row blocks of kRowsPerBlock).  A block whose rows are
//    all invalid writes (0, -1) and exits.
//  * Every warp of a block holds the block's rows (kRows per thread) and
//    scans its own share of D: each tile of kTile points is cut into one
//    segment per warp.  A warp compacts its segment to the valid points
//    and their indices in shared memory, in ascending index order (ballot
//    and prefix count), and runs over them with no per-point branch; no
//    barrier is needed until the end, where the warps' row minima are
//    combined.  D's padded tail costs its mask bytes, no arithmetic.  The
//    next segment is loaded into registers while the current one is
//    computed.
//  * Each thread keeps kAcc running (value, index) minima for each of its
//    rows, over interleaved points: each sees its points in ascending
//    index order and keeps the first on ties (strict `<`).  The thread's
//    minima, then the warps', are combined by (value, index), which keeps
//    the first index of the least value, exactly as argmin.
//  * The invalid points, skipped, are accounted for at the end: the plain
//    version sees each as BIG, so the least of them is (BIG, the first
//    invalid index), one more candidate of the combine.  It wins only
//    where no valid point lies below BIG (no valid point at all, or every
//    square overflowed past BIG).  The first valid index, with the value
//    infinity, is one more: it wins where every valid distance is
//    infinite and no point is invalid.
#include <cuda_runtime.h>
#include <limits.h>
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
constexpr int kAcc = 2;                           // (value, index) minima per row
constexpr int kPer = 4;                           // points per thread per tile
constexpr int kSeg = kPer * 32;                   // one warp's tile segment
constexpr int kTile = kWarps * kSeg;              // 1024 points per tile

// (v, j) < (m, mi) in (value, index) order
__device__ __forceinline__ bool lex_less(float v, int j, float m, int mi) {
  return v < m || (v == m && j < mi);
}

template <int W>
__global__ void __launch_bounds__(kThreads)
nn_distance_pairs_kernel(const float* __restrict__ qs,
                         const uint8_t* __restrict__ qsv,
                         const float* __restrict__ ds,
                         const uint8_t* __restrict__ dsv, int nq, int nd,
                         float* __restrict__ dist, int32_t* __restrict__ idx) {
  __shared__ float s_d[kWarps][kSeg * W];         // each warp's segment
  __shared__ int s_j[kWarps][kSeg];               // and its indices
  __shared__ float s_m[kWarps][kRowsPerBlock];    // each warp's row minima
  __shared__ int s_mi[kWarps][kRowsPerBlock];
  __shared__ int s_first_valid, s_first_invalid;  // nd where there is none

  const int p = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int base = blockIdx.y * kRowsPerBlock;
  const float* q = qs + (size_t)p * nq * W;
  const uint8_t* qv = qsv + (size_t)p * nq;
  float* o_d = dist + (size_t)p * nq;
  int32_t* o_i = idx + (size_t)p * nq;

  float qr[kRows][W];
  bool any = false;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = base + r * 32 + lane;
    const bool rv = row < nq && qv[row] != 0;
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
        if (row < nq) {
          o_d[row] = 0.0f;
          o_i[row] = -1;
        }
      }
    }
    return;
  }
  if (threadIdx.x == 0) {
    s_first_valid = nd;
    s_first_invalid = nd;
  }
  __syncthreads();

  float m[kRows][kAcc];
  int mi[kRows][kAcc];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int a = 0; a < kAcc; ++a) {
      m[r][a] = INFINITY;
      mi[r][a] = INT_MAX;
    }

  const float* d = ds + (size_t)p * nd * W;
  const uint8_t* dv = dsv + (size_t)p * nd;
  const unsigned below = (1u << lane) - 1u;
  float* seg = s_d[warp];
  int* seg_j = s_j[warp];

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
  // one point (index j) against every row, into minimum a
  auto visit = [&](const float* sp, int j, int a) {
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
      if (acc < m[r][a]) {
        m[r][a] = acc;
        mi[r][a] = j;
      }
    }
  };

  fetch(0);
  for (int t0 = 0; t0 < nd; t0 += kTile) {
    // compact this warp's valid points into its segment, in ascending
    // index order, and note the first valid and invalid index
    int n = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j0 = t0 + warp * kSeg + k * 32;
      const unsigned vote = __ballot_sync(0xffffffffu, ok[k]);
      const unsigned bad = __ballot_sync(0xffffffffu,
                                         !ok[k] && j0 + lane < nd);
      if (ok[k]) {
        const int at = n + __popc(vote & below);
#pragma unroll
        for (int c = 0; c < W; ++c) seg[at * W + c] = pr[k][c];
        seg_j[at] = j0 + lane;
      }
      if (lane == 0) {
        if (vote) atomicMin(&s_first_valid, j0 + __ffs(vote) - 1);
        if (bad) atomicMin(&s_first_invalid, j0 + __ffs(bad) - 1);
      }
      n += __popc(vote);
    }
    __syncwarp();
    if (t0 + kTile < nd) fetch(t0 + kTile);
    int t = 0;
#pragma unroll 2
    for (; t + kAcc <= n; t += kAcc) {
#pragma unroll
      for (int a = 0; a < kAcc; ++a)
        visit(seg + (t + a) * W, seg_j[t + a], a);
    }
    for (; t < n; ++t) visit(seg + t * W, seg_j[t], 0);
    __syncwarp();  // the segment is read before it is written again
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float v = m[r][0];
    int vi = mi[r][0];
#pragma unroll
    for (int a = 1; a < kAcc; ++a) {
      if (lex_less(m[r][a], mi[r][a], v, vi)) {
        v = m[r][a];
        vi = mi[r][a];
      }
    }
    s_m[warp][r * 32 + lane] = v;
    s_mi[warp][r * 32 + lane] = vi;
  }
  // also orders every update of the first indices before they are read
  __syncthreads();
  const int first_valid = s_first_valid;
  const int first_invalid = s_first_invalid;
  for (int i = threadIdx.x; i < kRowsPerBlock; i += kThreads) {
    const int row = base + i;
    if (row >= nq) continue;
    float v = s_m[0][i];
    int vi = s_mi[0][i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      if (lex_less(s_m[w][i], s_mi[w][i], v, vi)) {
        v = s_m[w][i];
        vi = s_mi[w][i];
      }
    }
    if (first_valid < nd && lex_less(INFINITY, first_valid, v, vi)) {
      v = INFINITY;
      vi = first_valid;
    }
    if (first_invalid < nd && lex_less(kBig, first_invalid, v, vi)) {
      v = kBig;
      vi = first_invalid;
    }
    const bool ok_row = qv[row] != 0;
    o_d[row] = ok_row ? sqrtf(v) : 0.0f;
    o_i[row] = ok_row ? vi : -1;
  }
}

template <int W>
int launch(const float* qs, const uint8_t* qsv, const float* ds,
           const uint8_t* dsv, int P, int nq, int nd, float* dist,
           int32_t* idx, cudaStream_t stream) {
  const dim3 grid(P, (nq + kRowsPerBlock - 1) / kRowsPerBlock);
  nn_distance_pairs_kernel<W><<<grid, kThreads, 0, stream>>>(
      qs, qsv, ds, dsv, nq, nd, dist, idx);
  return (int)cudaGetLastError();
}

}  // namespace

// qs (P, nq, W) f32, qsv (P, nq) bool, ds (P, nd, W) f32, dsv (P, nd) bool,
// all contiguous -> dist (P, nq) f32, idx (P, nq) int32.  W in 1..8.
// Returns cudaGetLastError() after the launch.
extern "C" int nn_distance_batched_launch(const float* qs, const uint8_t* qsv,
                                          const float* ds, const uint8_t* dsv,
                                          int P, int nq, int nd, int W,
                                          float* dist, int32_t* idx,
                                          void* stream) {
  if (P < 1 || nq < 1 || nd < 1 || nq > 65535 * kRowsPerBlock)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (W) {
#define CASE(w) \
    case w: return launch<w>(qs, qsv, ds, dsv, P, nq, nd, dist, idx, s);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
