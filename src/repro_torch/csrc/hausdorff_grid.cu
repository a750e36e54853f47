// Directed Hausdorff distance for the live lanes of an ExactHaus phase-2
// chunk, read straight from the resident corpus.
//
// Replaces: the Pallas kernel `_min_dist_grid_kernel` in
// src/repro/kernels/hausdorff.py (launcher `min_sq_dists_grid`) together
// with the epilogue of its wrapper `repro.kernels.ops.directed_hausdorff_grid`
// (min with BIG, sqrt, -BIG for invalid query rows, max over rows).
//
// What it computes: query rows q_c (B, nqp, W) whose first n_q[b] rows are
// query b's valid rows (compacted by the caller), the resident corpus
// pts (S, nd, W) / pts_valid (S, nd), the slot ids (B, C) and a live mask
// (B, C) -> H (B, C) with
//   H[b, c] = BIG                                  if the lane is dead,
//           = -BIG                                 if n_q[b] == 0,
//           = max over rows i < n_q[b] of sqrt(min(m_i, BIG)) otherwise,
//   m_i     = min over valid points j of slot ids[b, c] of
//             sum_k (q_c[b, i, k] - pts[ids[b, c], j, k])^2, from BIG.
// `extent[s]` bounds slot s's valid points: none lies at or past it.
// Squares are accumulated in coordinate order and the file is built with
// -fmad=false and IEEE sqrtf, so H is bitwise equal to the plain version
// (repro_torch/kernels/ops.py, `directed_hausdorff_lanes_plain`).  Every
// reordering below is exact: fminf / fmaxf return an operand, so a min or
// max is the same bits in any order and over any split, and a member that
// could only contribute BIG (an invalid point) or -BIG (an invalid row)
// changes nothing when skipped.
//
// What bounds it on this card: FP32 issue.  W = 2 costs 6 FP32
// instructions per (row, point) pair (2 sub, 2 mul, 1 add, 1 min); with
// -fmad=false there is no FMA, so the card retires at most 128 per clock
// per SM, 33.45 T/s on 132 SMs at 1.98 GHz.  The first chunk of the main
// path (B = 32, C = 32, all lanes live) holds 15.4 G such operations over
// its valid rows and points, a bound of 0.459 ms, against ~35 MB of input
// (0.01 ms at 3.35 TB/s).
//
// Design: the kernel does only live, valid work.
//  * Grid (B * C lanes, row blocks of kRowsPerBlock).  A block whose lane
//    is dead or whose row block lies past n_q[b] exits on entry, so dead
//    lanes and padded query rows cost a block launch and nothing more, and
//    the tail of the loop (few live queries) still spreads over the card.
//  * The candidate gather is fused into the tile loads: a block reads slot
//    ids[b, c]'s points from the resident tensor (contiguous, coalesced)
//    up to the slot's extent, and compacts each tile to its valid points
//    in shared memory (warp ballot and prefix count), so the inner loop
//    has no per-point branch.  A tile is loaded into registers while the
//    previous one is computed (two shared buffers, one barrier per tile).
//  * Each thread keeps kRows query rows in registers: one broadcast shared
//    load of a point feeds 6 * kRows FP32 instructions.  A warp whose rows
//    all lie past n_q[b] skips the arithmetic.
//  * Row blocks of one lane are combined exactly: a pre-pass sets live
//    outputs to -BIG and dead ones to BIG, and each block atomicMax-es the
//    int bits of its non-negative row maximum.  As signed ints every
//    non-negative float orders above -BIG, and among non-negative floats
//    the int order is the float order.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.4e38f;
constexpr int kPer = 4;                           // points per thread per tile
constexpr int kSeg = kPer * 32;                   // one warp's tile segment

// The launch shapes this file instantiates: (variant, warps a block, query
// rows a thread).  Variant 0, 4 warps of 2 rows, is the default: of 1-4
// warps x 1-8 rows it took least time per search on an H100 (more rows a
// thread left the card's tail emptier, fewer fed too little arithmetic per
// shared load).  The others are the tuner's candidates.
// repro_torch/kernels/autotune.py VARIANTS["hausdorff_grid"] lists the same
// shapes in the same order, and ROWS_PER_BLOCK in
// repro_torch/kernels/hausdorff.py is the default's rows per block.
#define HAUSDORFF_GRID_VARIANTS(X) X(0, 4, 2) X(1, 2, 2) X(2, 4, 1) X(3, 4, 4)

// one launch shape: threads, rows and points a block covers
template <int kWarps, int kRows>
struct Shape {
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kRowsPerBlock = kThreads * kRows;  // 256 by default
  static constexpr int kTile = kWarps * kSeg;   // points a tile, 512 by default
};

__global__ void hausdorff_lanes_init_kernel(const uint8_t* __restrict__ live,
                                            int n, float* __restrict__ H) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) H[i] = live[i] ? -kBig : kBig;
}

template <int W, int kWarps, int kRows>
__global__ void __launch_bounds__(kWarps * 32)
hausdorff_lanes_kernel(const float* __restrict__ q_c,
                       const int* __restrict__ n_q,
                       const float* __restrict__ pts,
                       const uint8_t* __restrict__ pts_valid,
                       const int* __restrict__ extent,
                       const int64_t* __restrict__ ids,
                       const uint8_t* __restrict__ live, int C, int nqp,
                       int S, int nd, float* __restrict__ H) {
  using Sh = Shape<kWarps, kRows>;
  constexpr int kRowsPerBlock = Sh::kRowsPerBlock;
  constexpr int kTile = Sh::kTile;
  // two buffers of compacted points; each warp fills its own segment
  __shared__ float s_d[2][kTile * W];
  __shared__ int s_n[2][kWarps];
  __shared__ float s_red[kWarps];

  const int lane_id = blockIdx.x;
  if (!live[lane_id]) return;
  const int b = lane_id / C;
  const int nrows = min(n_q[b], nqp);
  const int base = blockIdx.y * kRowsPerBlock;
  if (base >= nrows) return;
  const int64_t slot = ids[lane_id];
  if (slot < 0 || slot >= S) return;
  const int ext = min(extent[slot], nd);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wbase = base + warp * 32 * kRows;
  const bool active = wbase < nrows;

  const float* qb = q_c + (size_t)b * nqp * W;
  float qr[kRows][W];
  float m[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = wbase + r * 32 + lane;
#pragma unroll
    for (int c = 0; c < W; ++c)
      qr[r][c] = row < nrows ? qb[(size_t)row * W + c] : 0.0f;
    m[r] = kBig;
  }

  const float* d = pts + (size_t)slot * nd * W;
  const uint8_t* dv = pts_valid + (size_t)slot * nd;
  const unsigned below = (1u << lane) - 1u;

  // this thread's points of the tile at t0, held in registers
  float pr[kPer][W];
  bool ok[kPer];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = t0 + warp * kSeg + k * 32 + lane;
      ok[k] = j < ext && dv[j] != 0;
#pragma unroll
      for (int c = 0; c < W; ++c)
        pr[k][c] = ok[k] ? d[(size_t)j * W + c] : 0.0f;
    }
  };

  if (ext > 0) fetch(0);
  int buf = 0;
  for (int t0 = 0; t0 < ext; t0 += kTile) {
    // compact this warp's valid points into its segment of buffer `buf`
    float* seg = s_d[buf] + warp * kSeg * W;
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
    if (lane == 0) s_n[buf][warp] = n;
    // one barrier per tile: the other buffer was last read before it
    __syncthreads();
    if (t0 + kTile < ext) fetch(t0 + kTile);
    if (active) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float* sp = s_d[buf] + w * kSeg * W;
        const int cnt = s_n[buf][w];
#pragma unroll 4
        for (int t = 0; t < cnt; ++t) {
          float dp[W];
#pragma unroll
          for (int c = 0; c < W; ++c) dp[c] = sp[t * W + c];
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
    }
    buf ^= 1;
  }

  float hmax = -INFINITY;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = wbase + r * 32 + lane;
    if (row < nrows) hmax = fmaxf(hmax, sqrtf(fminf(m[r], kBig)));
  }
  for (int o = 16; o > 0; o >>= 1)
    hmax = fmaxf(hmax, __shfl_xor_sync(0xffffffffu, hmax, o));
  if (lane == 0) s_red[warp] = hmax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = s_red[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v = fmaxf(v, s_red[w]);
    // v >= 0: the block holds at least one valid row
    atomicMax(reinterpret_cast<int*>(H) + lane_id, __float_as_int(v));
  }
}

template <int W, int kWarps, int kRows>
int launch(const float* q_c, const int* n_q, const float* pts,
           const uint8_t* pts_valid, const int* extent, const int64_t* ids,
           const uint8_t* live, int B, int C, int nqp, int S, int nd,
           float* H, cudaStream_t stream) {
  using Sh = Shape<kWarps, kRows>;
  const int lanes = B * C;
  hausdorff_lanes_init_kernel<<<(lanes + 255) / 256, 256, 0, stream>>>(
      live, lanes, H);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const dim3 grid(lanes, (nqp + Sh::kRowsPerBlock - 1) / Sh::kRowsPerBlock);
  hausdorff_lanes_kernel<W, kWarps, kRows><<<grid, Sh::kThreads, 0, stream>>>(
      q_c, n_q, pts, pts_valid, extent, ids, live, C, nqp, S, nd, H);
  return (int)cudaGetLastError();
}

template <int kWarps, int kRows>
int launch_shape(const float* q_c, const int* n_q, const float* pts,
                 const uint8_t* pts_valid, const int* extent,
                 const int64_t* ids, const uint8_t* live, int B, int C,
                 int nqp, int S, int nd, int W, float* H,
                 cudaStream_t stream) {
  if (nqp > 65535 * Shape<kWarps, kRows>::kRowsPerBlock)
    return (int)cudaErrorInvalidValue;
  switch (W) {
#define CASE(w) \
    case w: return launch<w, kWarps, kRows>(q_c, n_q, pts, pts_valid, \
                                            extent, ids, live, B, C, nqp, \
                                            S, nd, H, stream);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q_c (B, nqp, W) f32, n_q (B,) int32, pts (S, nd, W) f32, pts_valid
// (S, nd) bool, extent (S,) int32, ids (B, C) int64, live (B, C) bool, all
// contiguous -> H (B, C) f32.  W in 1..8; `variant` indexes
// HAUSDORFF_GRID_VARIANTS.  Two launches on `stream` (the output pre-pass,
// then the lanes); returns cudaGetLastError().
extern "C" int hausdorff_lanes_launch(const float* q_c, const int* n_q,
                                      const float* pts,
                                      const uint8_t* pts_valid,
                                      const int* extent, const int64_t* ids,
                                      const uint8_t* live, int B, int C,
                                      int nqp, int S, int nd, int W,
                                      int variant, float* H, void* stream) {
  if (B < 1 || C < 1 || nqp < 1 || S < 1 || nd < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
#define VARIANT(v, warps, rows) \
    case v: return launch_shape<warps, rows>(q_c, n_q, pts, pts_valid, \
                                             extent, ids, live, B, C, nqp, \
                                             S, nd, W, H, s);
    HAUSDORFF_GRID_VARIANTS(VARIANT)
#undef VARIANT
    default: return (int)cudaErrorInvalidValue;
  }
}
