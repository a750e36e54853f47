// GBO counts: popcount(AND) between two stacks of z-order signatures.
//
// Replaces: the Pallas kernel `_intersect_kernel` in
// src/repro/kernels/set_intersect.py (launcher `intersect_counts`, wrapper
// `repro.kernels.ops.set_intersect_counts`).  On the port's path it scores
// every (query, slot) pair of a top-k GBO dispatch.
//
// What it computes: sa (na, W), sb (nb, W) signature words ->
//   out[i, j] = sum over w of popcount(sa[i, w] & sb[j, w])   (int32).
// The port holds each uint32 signature word in an int64 (values in
// [0, 2^32)); the kernel counts all 64 bits with __popcll, as the plain
// version's SWAR count does, so the two agree exactly on any int64 input.
//
// What bounds it on this card: popcount issue.  At the main path's shape
// (na = 64: a GBO group of 40 query rows padded to its bucket, nb = 16384
// slots, W = 32 words) it reads 4.2 MB of slot signatures and writes
// 4.2 MB of counts (about 2.5 us of bytes), against one 32-bit popcount
// per word pair, 33.5 M in all: about 8 us at 16 per clock per SM.
//
// Design: grid (ceil(nb / 128), ceil(na / 16)), one thread per slot j and
// a strip of 16 query rows i, whose 16 counts stay in registers.  Each
// thread reads its slot's words once for its strip; the query words
// are the same address across the block, so they are broadcast loads
// served from L1.  Writes are coalesced along j.  Ragged na and nb are
// masked in the kernel; nothing is padded.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 16;

__global__ void __launch_bounds__(kThreads)
set_intersect_kernel(const int64_t* __restrict__ sa,
                     const int64_t* __restrict__ sb, int na, int nb, int W,
                     int32_t* __restrict__ out) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const int i0 = blockIdx.y * kRows;
  const int rows = min(kRows, na - i0);
  if (j >= nb) return;
  int acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0;
  const int64_t* b_row = sb + (size_t)j * W;
  const int64_t* a_rows = sa + (size_t)i0 * W;
  for (int w = 0; w < W; ++w) {
    const unsigned long long b = (unsigned long long)b_row[w];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows)
        acc[r] += __popcll((unsigned long long)a_rows[(size_t)r * W + w] & b);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < rows) out[(size_t)(i0 + r) * nb + j] = acc[r];
  }
}

}  // namespace

// sa (na, W), sb (nb, W) int64, contiguous -> out (na, nb) int32.
// Returns cudaGetLastError() after the launch.
extern "C" int set_intersect_launch(const int64_t* sa, const int64_t* sb,
                                    int na, int nb, int W, int32_t* out,
                                    void* stream) {
  if (na < 1 || nb < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((nb + kThreads - 1) / kThreads, (na + kRows - 1) / kRows);
  set_intersect_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      sa, sb, na, nb, W, out);
  return (int)cudaGetLastError();
}
