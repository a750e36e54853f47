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
// count as BIG, unoccupied query nodes as -BIG.  The result is bitwise
// equal to the plain version (repro_torch/kernels/ref.py
// frontier_bound_levels): squares are accumulated in coordinate order,
// rd*rd is its own product, and the file is built with -fmad=false and
// IEEE sqrtf.  Two steps reorder it, both exactly: IEEE sqrtf, "+ rq" and
// "max(., 0)" are monotone non-decreasing, so they commute with a min
// (min_j sqrt(x_j) + rq = sqrt(min_j x_j) + rq, bit for bit), and fminf /
// fmaxf return an operand, so a min over the occupied nodes, then one min
// with BIG where the level holds an unoccupied node, is the plain min over
// all of them.
//
// What bounds it on this card: at the main path's shape (B = 32 queries,
// S = 16384 slots, N = 15 nodes in 4 levels, W = 2) it reads ~3 MB of
// corpus nodes and writes 2 x 4 x 32 x 16384 floats (~17 MB, 0.006 ms at
// 3.35 TB/s).  Its work is 3W + 3 FP32 operations (cd^2, cd - rd,
// cd^2 + rd^2, two mins) and one root per pair of occupied nodes, plus a
// root and 4 operations per occupied query node: with every node occupied,
// 0.44 G operations at 33.45 T/s (128 per clock per SM; -fmad=false allows
// no FMA) and 52 M roots at one MUFU each, 16 per clock per SM
// (4.18 T/s), 0.013 ms each.  Trees are padded to the widest dataset, so
// on T-Drive-sized data most nodes are empty: 62 M operations and 8.3 M
// roots, and the bytes bound it at 0.006 ms.
//
// Design: grid (slot tiles of kSlots, query groups of kQueries), one
// thread per slot.  The block stages its slots' centers, radii and
// occupancy with coalesced loads (a tile is one contiguous range of `od`)
// into shared memory, node-major so that reads are free of bank conflicts,
// and its queries' nodes beside them (read as broadcasts).  For each level
// a thread loads its slot's nodes of the level into registers once (up to
// kReg at a time) and runs every query of the group against them.  UB
// takes one root per row, LB one per pair; a row of an unoccupied query
// node, and the pairs of a level where the slot has no occupied node, are
// skipped.  Only the running row min and level max live in registers; the
// dense (N x N) bound tensor is never stored.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.4e38f;
constexpr int kMaxLevels = 32;

// The launch shapes this file instantiates: (variant, slots a block = its
// threads, queries a block, corpus nodes held in registers at once).
// Variant 0, 128 x 4 x 8, is the default; the others are the tuner's
// candidates.  None holds more slots a block than the default, so none
// needs much more shared memory (the slots' nodes are most of it).
// repro_torch/kernels/autotune.py VARIANTS["bound_grid"] lists the same
// shapes in the same order.
#define BOUND_GRID_VARIANTS(X) \
  X(0, 128, 4, 8) X(1, 64, 4, 8) X(2, 128, 2, 8) X(3, 128, 8, 8)

struct Levels {
  int n;
  int start[kMaxLevels];
  int stop[kMaxLevels];
};

// up to kReg corpus nodes [j0, j0 + n) of one slot, in registers; shared
// memory holds kSlots slots
template <int W, int kSlots, int kReg>
struct Nodes {
  float x[kReg][W];
  float rd[kReg];
  float rd2[kReg];
  bool ok[kReg];
  int n;

  __device__ void load(const float* s_od, const float* s_rd,
                       const uint8_t* s_dok, int j0, int cnt, int t) {
    n = cnt;
#pragma unroll
    for (int k = 0; k < kReg; ++k) {
      const int j = j0 + k;
      if (k < cnt) {
#pragma unroll
        for (int c = 0; c < W; ++c) x[k][c] = s_od[(j * W + c) * kSlots + t];
        rd[k] = s_rd[j * kSlots + t];
        ok[k] = s_dok[j * kSlots + t] != 0;
      } else {
#pragma unroll
        for (int c = 0; c < W; ++c) x[k][c] = 0.0f;
        rd[k] = 0.0f;
        ok[k] = false;
      }
      rd2[k] = rd[k] * rd[k];
    }
  }

  // running min over the occupied nodes of (cd - rd) and (cd^2 + rd^2);
  // the root is taken before the occupancy select, so IEEE sqrtf never
  // meets INF (its slow path)
  template <int K>
  __device__ void row_k(const float* qx, float& mx, float& mu) const {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (K == kReg && k >= n) break;    // uniform across the block
      float diff = qx[0] - x[k][0];
      float acc = diff * diff;
#pragma unroll
      for (int c = 1; c < W; ++c) {
        diff = qx[c] - x[k][c];
        const float sq = diff * diff;
        acc = acc + sq;
      }
      const float cd = sqrtf(acc);
      mx = fminf(mx, ok[k] ? cd - rd[k] : INFINITY);
      mu = fminf(mu, ok[k] ? acc + rd2[k] : INFINITY);
    }
  }

  // levels of 1, 2 and 4 nodes run unrolled to their width, so the
  // nodes' arithmetic interleaves
  __device__ void row(const float* qx, float& mx, float& mu) const {
    switch (n) {
      case 1: row_k<1>(qx, mx, mu); break;
      case 2: row_k<2>(qx, mx, mu); break;
      case 4: row_k<4>(qx, mx, mu); break;
      default: row_k<kReg>(qx, mx, mu); break;
    }
  }
};

template <int W, int kSlots, int kQueries, int kReg>
__global__ void __launch_bounds__(kSlots)
bound_grid_kernel(const float* __restrict__ oq, const float* __restrict__ rq,
                  const uint8_t* __restrict__ q_ok,
                  const float* __restrict__ od, const float* __restrict__ rd,
                  const uint8_t* __restrict__ d_ok, Levels levels, int B,
                  int S, int N, float* __restrict__ LB,
                  float* __restrict__ UB) {
  extern __shared__ float smem[];
  float* s_od = smem;                          // [N * W][kSlots]
  float* s_rd = s_od + N * W * kSlots;         // [N][kSlots]
  float* s_oq = s_rd + N * kSlots;             // [kQueries][N * W]
  float* s_rq = s_oq + kQueries * N * W;       // [kQueries][N]
  uint8_t* s_dok = reinterpret_cast<uint8_t*>(s_rq + kQueries * N);
  uint8_t* s_qok = s_dok + N * kSlots;         // [kQueries][N]

  const int t = threadIdx.x;
  const int s0 = blockIdx.x * kSlots;
  const int ns = min(kSlots, S - s0);
  const int b0 = blockIdx.y * kQueries;
  const int nb = min(kQueries, B - b0);
  const int NW = N * W;

  for (int e = t; e < ns * NW; e += kSlots) {
    const int slot = e / NW;
    s_od[(e - slot * NW) * kSlots + slot] = od[(size_t)s0 * NW + e];
  }
  for (int e = t; e < ns * N; e += kSlots) {
    const int slot = e / N;
    const int j = e - slot * N;
    s_rd[j * kSlots + slot] = rd[(size_t)s0 * N + e];
    s_dok[j * kSlots + slot] = d_ok[(size_t)s0 * N + e];
  }
  for (int e = t; e < nb * NW; e += kSlots)
    s_oq[e] = oq[(size_t)b0 * NW + e];
  for (int e = t; e < nb * N; e += kSlots) {
    s_rq[e] = rq[(size_t)b0 * N + e];
    s_qok[e] = q_ok[(size_t)b0 * N + e];
  }
  __syncthreads();
  if (t >= ns) return;
  const int s = s0 + t;

  Nodes<W, kSlots, kReg> nodes;
  for (int l = 0; l < levels.n; ++l) {
    const int a = levels.start[l];
    const int e = levels.stop[l];
    const bool small = e - a <= kReg;
    bool occ = false, unocc = false;
    for (int j = a; j < e; ++j) {
      const bool ok = s_dok[j * kSlots + t] != 0;
      occ |= ok;
      unocc |= !ok;
    }
    // the BIG of an unoccupied corpus node, applied once per row
    const float cap = unocc ? kBig : INFINITY;
    if (small) nodes.load(s_od, s_rd, s_dok, a, e - a, t);
    for (int qb = 0; qb < nb; ++qb) {
      float lb_max = -INFINITY;
      float ub_max = -INFINITY;
      for (int i = a; i < e; ++i) {
        if (!s_qok[qb * N + i]) {          // uniform across the block
          lb_max = fmaxf(lb_max, -kBig);
          ub_max = fmaxf(ub_max, -kBig);
          continue;
        }
        float qx[W];
#pragma unroll
        for (int c = 0; c < W; ++c) qx[c] = s_oq[qb * NW + i * W + c];
        float mx = INFINITY;
        float mu = INFINITY;
        if (occ) {
          if (small) {
            nodes.row(qx, mx, mu);
          } else {
            for (int j0 = a; j0 < e; j0 += kReg) {
              nodes.load(s_od, s_rd, s_dok, j0, min(kReg, e - j0), t);
              nodes.row(qx, mx, mu);
            }
          }
        }
        // no occupied node: every pair was BIG (and cap is BIG)
        const float row_lb = occ ? fminf(fmaxf(mx, 0.0f), cap) : kBig;
        const float row_ub =
            occ ? fminf(sqrtf(mu) + s_rq[qb * N + i], cap) : kBig;
        lb_max = fmaxf(lb_max, row_lb);
        ub_max = fmaxf(ub_max, row_ub);
      }
      const size_t o = ((size_t)l * B + b0 + qb) * S + s;
      LB[o] = lb_max;
      UB[o] = ub_max;
    }
  }
}

template <int W, int kSlots, int kQueries, int kReg>
int launch(const float* oq, const float* rq, const uint8_t* q_ok,
           const float* od, const float* rd, const uint8_t* d_ok,
           const Levels& levels, int B, int S, int N, float* LB, float* UB,
           cudaStream_t stream) {
  const size_t shmem = (size_t)N * (W + 1) * kSlots * sizeof(float)
                       + (size_t)kQueries * N * (W + 1) * sizeof(float)
                       + (size_t)N * kSlots + (size_t)kQueries * N;
  auto kernel = bound_grid_kernel<W, kSlots, kQueries, kReg>;
  if (shmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((S + kSlots - 1) / kSlots, (B + kQueries - 1) / kQueries);
  kernel<<<grid, kSlots, shmem, stream>>>(oq, rq, q_ok, od, rd, d_ok, levels,
                                          B, S, N, LB, UB);
  return (int)cudaGetLastError();
}

template <int kSlots, int kQueries, int kReg>
int launch_shape(const float* oq, const float* rq, const uint8_t* q_ok,
                 const float* od, const float* rd, const uint8_t* d_ok,
                 const Levels& levels, int B, int S, int N, int W, float* LB,
                 float* UB, cudaStream_t stream) {
  if ((B + kQueries - 1) / kQueries > 65535)
    return (int)cudaErrorInvalidValue;
  switch (W) {
#define CASE(w) \
    case w: return launch<w, kSlots, kQueries, kReg>( \
        oq, rq, q_ok, od, rd, d_ok, levels, B, S, N, LB, UB, stream);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// oq (B, N, W), rq / q_ok (B, N), od (S, N, W), rd / d_ok (S, N), all
// contiguous; level slices given as two host arrays of L ints; W in 1..8;
// `variant` indexes BOUND_GRID_VARIANTS.  Writes LB, UB (L, B, S).
// Returns cudaGetLastError() after the launch.
extern "C" int bound_grid_launch(const float* oq, const float* rq,
                                 const uint8_t* q_ok, const float* od,
                                 const float* rd, const uint8_t* d_ok,
                                 const int* starts, const int* stops, int L,
                                 int B, int S, int N, int W, int variant,
                                 float* LB, float* UB, void* stream) {
  if (L < 1 || L > kMaxLevels || B < 1 || S < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  Levels levels;
  levels.n = L;
  for (int l = 0; l < L; ++l) {
    levels.start[l] = starts[l];
    levels.stop[l] = stops[l];
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
#define VARIANT(v, slots, queries, reg) \
    case v: return launch_shape<slots, queries, reg>( \
        oq, rq, q_ok, od, rd, d_ok, levels, B, S, N, W, LB, UB, s);
    BOUND_GRID_VARIANTS(VARIANT)
#undef VARIANT
    default: return (int)cudaErrorInvalidValue;
  }
}
