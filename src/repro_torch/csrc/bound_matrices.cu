// Eq. 4 bounds between two node frontiers, for a batch of pairs: the
// (lb, ub) matrices, and the fused row upper bound of the pruned NNP.
//
// Replaces: the Pallas kernel `_bound_kernel` in
// src/repro/kernels/bound_matrix.py (launcher `bound_matrices`, wrapper
// `repro.kernels.ops.bound_matrices`), and in `bound_row_ub` the
// `jnp.where` + `jnp.min` that src/repro/core/point_search.py
// (`nnp_pruned_core`) applies to its `ub`.
//
// What they compute: oq (P, nq, W), rq (P, nq), od (P, nd, W), rd (P, nd),
// d_ok (P, nd) ->
//   cd2 = sum_k (oq[p,i,k] - od[p,j,k])^2   (squares in coordinate order)
//   lb[p,i,j] = max(sqrtf(cd2) - rd[p,j], 0)
//   ub[p,i,j] = sqrtf(cd2 + rd[p,j] * rd[p,j]) + rq[p,i]
//   row_ub[p,i] = min over j of (d_ok[p,j] ? ub[p,i,j] : BIG)
// (paper Eq. 4), with rd*rd its own product as in the plain versions
// (repro_torch/kernels/ref.py bound_matrix, bound_row_ub).  Built with
// -fmad=false and IEEE sqrtf, so every output is bitwise equal to them.
// `bound_row_ub` reorders the plain min exactly: IEEE sqrtf and "+ rq" are
// monotone non-decreasing, so min_j (sqrtf(x_j) + rq) = sqrtf(min_j x_j)
// + rq bit for bit, with x_j = cd2 + rd_j * rd_j; a min returns one of its
// operands, so the min over the occupied nodes only, then one min with BIG
// where the row has an unoccupied node, is the plain min over all of them
// (BIG where none is occupied).  The mins are PTX `min.NaN`, which, as
// `torch.amin`, returns NaN when an operand is NaN.  Masked nodes never
// enter the min, whatever their centers hold.
//
// What bounds them on this card.  The matrix form writes 2 x P nq nd
// floats: at the pruned NNP's shape (P = 128 pairs, nq = nd = 256 leaves,
// W = 2) 67 MB, 0.020 ms at 3.35 TB/s (0.010 ms with ub only), against
// 11 FP32 operations and two roots per node pair (2.8 us and 4.0 us of
// issue).  The row form writes P nq floats and reads the frontiers once,
// about 1.05 MB (0.31 us); its work is 3W + 1 FP32 operations per pair of
// a query node and an occupied corpus node (7 at W = 2: at most 58.7 M,
// 1.75 us at 128 per clock per SM) and one root per row.  It is bound by
// FP32 issue, and on the main path's data, where most leaves of the
// padded trees are empty, by far less.
//
// Design, matrix form: grid (ceil(nd / 256), ceil(nq / 16), P), 256
// threads; a thread holds 4 consecutive corpus nodes in registers and runs
// 4 query rows against them, so each node read serves 4 rows and each row
// read 4 nodes, and it writes 4 consecutive j with one 16-byte store per
// output (streaming, since the matrices outgrow L2).  lb is optional: a
// null pointer writes ub only.  Design, row form: grid (ceil(nq / 128), P),
// 256 threads.  The block stages its pair's occupied corpus nodes into
// shared memory once, compacted (a warp ballot and one shared counter per
// warp) as (x, rd * rd) records of a 16-byte multiple, in chunks of
// kChunk nodes, all of a chunk's loads issued before any is used; each
// group of 4 lanes owns 2 query rows, each lane takes every 4th staged
// node, so one 16-byte shared load feeds 2 rows, and the lanes' minima
// meet by shuffles.  Only the running minimum per row lives in registers:
// no atomics on the output, no second pass, one root per row.  The work
// per block is small, so the launch and the round trip to memory set
// much of its time, and a pair whose leaves are all occupied sets the
// rest; two blocks per pair at the path's nq = 256 split such a pair over
// two SMs.  Of 2, 4, 8 and 16 lanes x 1, 2 and 4 rows at 128 and 256
// threads, chunks of 256 and 512 nodes and the node loop unrolled 2, 4
// and 8 times, tried on the card, this shape took least.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.4e38f;

// the min of two floats, NaN if either is NaN, as torch.amin
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// ---- the matrix form -----------------------------------------------------

constexpr int kMatThreads = 256;
constexpr int kMatColThreads = 64;            // threads along j, 4 j each
constexpr int kMatJ = 4 * kMatColThreads;     // j per block
constexpr int kMatRowsPerThread = 4;
constexpr int kMatRows = (kMatThreads / kMatColThreads) * kMatRowsPerThread;

template <int W, bool kLB, bool kVec>
__global__ void __launch_bounds__(kMatThreads)
bound_matrices_kernel(const float* __restrict__ oq,
                      const float* __restrict__ rq,
                      const float* __restrict__ od,
                      const float* __restrict__ rd, int nq, int nd,
                      float* __restrict__ lb, float* __restrict__ ub) {
  const int tx = threadIdx.x % kMatColThreads;
  const int ty = threadIdx.x / kMatColThreads;
  const int j0 = blockIdx.x * kMatJ + 4 * tx;
  const int i0 = blockIdx.y * kMatRows + ty * kMatRowsPerThread;
  const size_t p = blockIdx.z;
  if (j0 >= nd || i0 >= nq) return;
  // 4 corpus nodes in registers; past nd a node repeats the last one and
  // its outputs are not stored
  float x[4][W], r[4], r2[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const size_t j = p * nd + min(j0 + k, nd - 1);
#pragma unroll
    for (int c = 0; c < W; ++c) x[k][c] = od[j * W + c];
    r[k] = rd[j];
    r2[k] = r[k] * r[k];
  }
#pragma unroll
  for (int rr = 0; rr < kMatRowsPerThread; ++rr) {
    const int i = i0 + rr;
    if (i >= nq) break;
    const size_t qi = p * nq + i;
    float q[W];
#pragma unroll
    for (int c = 0; c < W; ++c) q[c] = oq[qi * W + c];
    const float rqi = rq[qi];
    float l[4], u[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float diff = q[0] - x[k][0];
      float acc = diff * diff;
#pragma unroll
      for (int c = 1; c < W; ++c) {
        diff = q[c] - x[k][c];
        const float sq = diff * diff;
        acc = acc + sq;
      }
      l[k] = fmaxf(sqrtf(acc) - r[k], 0.0f);
      u[k] = sqrtf(acc + r2[k]) + rqi;
    }
    const size_t o = qi * nd + j0;
    if (kVec) {               // nd % 4 == 0: j0 .. j0 + 3 all inside
      __stcs(reinterpret_cast<float4*>(ub + o),
             make_float4(u[0], u[1], u[2], u[3]));
      if (kLB)
        __stcs(reinterpret_cast<float4*>(lb + o),
               make_float4(l[0], l[1], l[2], l[3]));
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (j0 + k < nd) {
          ub[o + k] = u[k];
          if (kLB) lb[o + k] = l[k];
        }
      }
    }
  }
}

template <int W, bool kLB>
int launch_matrix_form(const float* oq, const float* rq, const float* od,
                       const float* rd, int P, int nq, int nd, float* lb,
                       float* ub, cudaStream_t stream) {
  const dim3 grid((nd + kMatJ - 1) / kMatJ, (nq + kMatRows - 1) / kMatRows,
                  P);
  if (nd % 4 == 0)
    bound_matrices_kernel<W, kLB, true><<<grid, kMatThreads, 0, stream>>>(
        oq, rq, od, rd, nq, nd, lb, ub);
  else
    bound_matrices_kernel<W, kLB, false><<<grid, kMatThreads, 0, stream>>>(
        oq, rq, od, rd, nq, nd, lb, ub);
  return (int)cudaGetLastError();
}

template <int W>
int launch_matrix(const float* oq, const float* rq, const float* od,
                  const float* rd, int P, int nq, int nd, float* lb,
                  float* ub, cudaStream_t stream) {
  return lb ? launch_matrix_form<W, true>(oq, rq, od, rd, P, nq, nd, lb,
                                          ub, stream)
            : launch_matrix_form<W, false>(oq, rq, od, rd, P, nq, nd, lb,
                                           ub, stream);
}

// ---- the row form ----------------------------------------------------------

constexpr int kUbThreads = 256;
constexpr int kUbLanes = 4;          // lanes sharing a row group
constexpr int kUbRowsPerGroup = 2;   // query rows of a row group
constexpr int kUbRows = (kUbThreads / kUbLanes) * kUbRowsPerGroup;
constexpr int kChunk = 512;          // corpus nodes staged at once
constexpr int kPer = kChunk / kUbThreads;   // of them, a thread's

template <int W>
__global__ void __launch_bounds__(kUbThreads)
bound_row_ub_kernel(const float* __restrict__ oq,
                    const float* __restrict__ rq,
                    const float* __restrict__ od,
                    const float* __restrict__ rd,
                    const uint8_t* __restrict__ d_ok, int nq, int nd,
                    float* __restrict__ out) {
  // floats of one staged node: W coordinates and rd * rd, padded to 16
  // bytes
  constexpr int R = (W + 1 + 3) / 4 * 4;
  __shared__ __align__(16) float s_node[kChunk * R];
  __shared__ int s_count;

  const int t = threadIdx.x;
  const int warp_lane = t % 32;
  const int lane = t % kUbLanes;
  const int i0 = blockIdx.x * kUbRows + (t / kUbLanes) * kUbRowsPerGroup;
  const size_t p = blockIdx.y;

  // this group's query rows; a row past nq repeats the last one and is
  // not stored (every lane stays for the shuffles)
  float q[kUbRowsPerGroup][W];
#pragma unroll
  for (int r = 0; r < kUbRowsPerGroup; ++r) {
    const size_t qi = p * nq + min(i0 + r, nq - 1);
#pragma unroll
    for (int c = 0; c < W; ++c) q[r][c] = oq[qi * W + c];
  }
  float m[kUbRowsPerGroup];
#pragma unroll
  for (int r = 0; r < kUbRowsPerGroup; ++r) m[r] = INFINITY;

  bool hole = false;      // this thread saw an unoccupied node
  int occupied = 0;       // occupied nodes of the pair, the same in all
  for (int c0 = 0; c0 < nd; c0 += kChunk) {
    const int n = min(kChunk, nd - c0);
    if (t == 0) s_count = 0;
    __syncthreads();
    // stage the chunk's occupied nodes, compacted in any order.  Every
    // load of the chunk is issued before any is used, so the block waits
    // for one round trip to memory, not one per load
    float x[kPer][W], r[kPer];
    bool ok[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int k = u * kUbThreads + t;
      const size_t j = p * nd + c0 + min(k, n - 1);
      const bool occupied_j = d_ok[j] != 0;
      ok[u] = k < n && occupied_j;
      hole |= k < n && !occupied_j;
#pragma unroll
      for (int c = 0; c < W; ++c) x[u][c] = od[j * W + c];
      r[u] = rd[j];
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const unsigned occ = __ballot_sync(0xffffffffu, ok[u]);
      int base = 0;
      if (warp_lane == 0 && occ) base = atomicAdd(&s_count, __popc(occ));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (ok[u]) {
        float* dst = s_node + (base + __popc(occ & ((1u << warp_lane) - 1)))
                                  * R;
#pragma unroll
        for (int c = 0; c < W; ++c) dst[c] = x[u][c];
        dst[W] = r[u] * r[u];
      }
    }
    __syncthreads();
    const int cnt = s_count;
    occupied += cnt;
#pragma unroll 4
    for (int k = lane; k < cnt; k += kUbLanes) {
      float y[R];
#pragma unroll
      for (int v = 0; v < R; v += 4) {
        const float4 f = *reinterpret_cast<const float4*>(s_node + k * R + v);
        y[v] = f.x;
        y[v + 1] = f.y;
        y[v + 2] = f.z;
        y[v + 3] = f.w;
      }
#pragma unroll
      for (int r = 0; r < kUbRowsPerGroup; ++r) {
        float diff = q[r][0] - y[0];
        float acc = diff * diff;
#pragma unroll
        for (int c = 1; c < W; ++c) {
          diff = q[r][c] - y[c];
          const float sq = diff * diff;
          acc = acc + sq;
        }
        m[r] = min_nan(m[r], acc + y[W]);
      }
    }
    __syncthreads();      // the next chunk overwrites s_node
  }
  hole = __syncthreads_or(hole);
#pragma unroll
  for (int r = 0; r < kUbRowsPerGroup; ++r) {
#pragma unroll
    for (int off = kUbLanes / 2; off > 0; off /= 2)
      m[r] = min_nan(m[r], __shfl_xor_sync(0xffffffffu, m[r], off));
  }
  if (lane != 0) return;
#pragma unroll
  for (int r = 0; r < kUbRowsPerGroup; ++r) {
    const int i = i0 + r;
    if (i >= nq) break;
    const size_t qi = p * nq + i;
    float v = kBig;                       // no occupied node: all BIG
    if (occupied > 0) {
      v = sqrtf(m[r]) + rq[qi];
      if (hole) v = min_nan(v, kBig);
    }
    out[qi] = v;
  }
}

template <int W>
int launch_row_ub(const float* oq, const float* rq, const float* od,
                  const float* rd, const uint8_t* d_ok, int P, int nq,
                  int nd, float* out, cudaStream_t stream) {
  const dim3 grid((nq + kUbRows - 1) / kUbRows, P);
  bound_row_ub_kernel<W><<<grid, kUbThreads, 0, stream>>>(
      oq, rq, od, rd, d_ok, nq, nd, out);
  return (int)cudaGetLastError();
}

}  // namespace

// oq (P, nq, W), rq (P, nq), od (P, nd, W), rd (P, nd), all contiguous ->
// ub and, unless lb is null, lb, each (P, nq, nd).  W in 1..8; P at most
// 65535 and ceil(nq / 16) too (grid limits).  Returns cudaGetLastError()
// after the launch.
extern "C" int bound_matrices_launch(const float* oq, const float* rq,
                                     const float* od, const float* rd, int P,
                                     int nq, int nd, int W, float* lb,
                                     float* ub, void* stream) {
  if (P < 1 || nq < 1 || nd < 1 || P > 65535 ||
      (nq + kMatRows - 1) / kMatRows > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (W) {
#define CASE(w) \
    case w: return launch_matrix<w>(oq, rq, od, rd, P, nq, nd, lb, ub, s);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// oq (P, nq, W), rq (P, nq), od (P, nd, W), rd (P, nd), d_ok (P, nd) bool,
// all contiguous -> out (P, nq), the min over j of d_ok ? ub : BIG.
// W in 1..8; P at most 65535.  Returns cudaGetLastError() after the
// launch.
extern "C" int bound_row_ub_launch(const float* oq, const float* rq,
                                   const float* od, const float* rd,
                                   const uint8_t* d_ok, int P, int nq,
                                   int nd, int W, float* out, void* stream) {
  if (P < 1 || nq < 1 || nd < 1 || P > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (W) {
#define CASE(w) \
    case w: return launch_row_ub<w>(oq, rq, od, rd, d_ok, P, nq, nd, out, s);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
