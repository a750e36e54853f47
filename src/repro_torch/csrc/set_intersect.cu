// GBO counts: popcount(AND) between two stacks of z-order signatures, on
// the binary tensor cores.
//
// Replaces: the Pallas kernel `_intersect_kernel` in
// src/repro/kernels/set_intersect.py (launcher `intersect_counts`, wrapper
// `repro.kernels.ops.set_intersect_counts`).  On the port's path it scores
// every (query, slot) pair of a top-k GBO dispatch.
//
// What it computes: sa (na, W), sb (nb, W) signature words ->
//   out[i, j] = sum over w of popcount(sa[i, w] & sb[j, w])   (int32).
// That is a product of two bit matrices with AND for the multiply and a
// popcount for the sum, which the tensor cores do exactly:
// `mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc` adds
// popcount(a & b) over 256 bits for a 16 x 8 tile.  The port holds each
// uint32 signature word in an int64 (values in [0, 2^32)), and the plain
// version's SWAR count counts all 64 bits.  The tensor cores see the low
// 32 bits; the kernel is exact on any int64 input because it ORs together
// the high halves of the words of each chunk it reads (the block's query
// rows, the warp's slots), and where one of them is not zero that warp
// counts the chunk with __popcll straight from global memory (a
// warp-uniform branch, never taken on signatures).
//
// What bounds it on this card: memory.  At the main path's shape (na = 64:
// a GBO group of 40 query rows padded to its bucket, nb = 16384 slots,
// W = 32 words) it reads 4.2 MB of slot signatures and writes 4.2 MB of
// counts: 0.0025 ms at 3.35 TB/s.  The same sums as 32-bit popcounts,
// 33.5 M of them at 16 per clock per SM, would take 0.0080 ms, which
// bounded this kernel's first design (one popcount pipe); the binary
// tensor cores take them off that pipe, and their rate is not among the
// published ones, so the bound is the bytes.
//
// Design: grid (ceil(nb / 64), ceil(na / 64)), 8 warps a block.  The block
// stages its 64 query rows, 32 words at a time, into shared memory as
// 32-bit words (rows padded to 36 words, so the fragment loads are free of
// bank conflicts); each warp loads the 32 words of its 8 slots straight
// into B fragments, and runs 4 m-tiles x 4 k-steps of m16n8k256 against
// them, the 16 counts of its 64 x 8 tile in registers.  Counts are written
// 8 bytes a thread.  Ragged na, nb and W are masked in the kernel (zero
// words count nothing); nothing is padded.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 64;                  // query rows of a block: 4 m-tiles
constexpr int kSlots = 8 * kWarps;         // slots of a block: 8 a warp
constexpr int kWords = 32;                 // words a chunk: 4 k-steps
constexpr int kStride = kWords + 4;        // padded row of staged words

// c += popcount(a & b) over the 256 bits of one k-step, for a 16 x 8 tile
__device__ __forceinline__ void mma_and_popc(int (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
set_intersect_kernel(const int64_t* __restrict__ sa,
                     const int64_t* __restrict__ sb, int na, int nb, int W,
                     int32_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t s_a[kRows][kStride];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;        // fragment row of A, column (slot) of B
  const int tig = lane % 4;      // which words of a k-step the thread holds
  const int i0 = blockIdx.y * kRows;
  const int nat = min(kRows, na - i0);
  const int n0 = blockIdx.x * kSlots + warp * 8;
  const int slot = n0 + g;

  int c[4][4];                   // [m-tile][fragment]: rows g, g + 8
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int v = 0; v < 4; ++v) c[m][v] = 0;

  for (int w0 = 0; w0 < W; w0 += kWords) {
    const int wc = min(kWords, W - w0);
    uint32_t hi = 0;
    for (int e = threadIdx.x; e < kRows * kWords; e += kThreads) {
      const int r = e / kWords;
      const int w = e % kWords;
      uint64_t v = 0;
      if (r < nat && w < wc) v = (uint64_t)sa[(size_t)(i0 + r) * W + w0 + w];
      s_a[r][w] = (uint32_t)v;
      hi |= (uint32_t)(v >> 32);
    }
    // the warp's slot words of the chunk, 8 a thread: in k-step ks the
    // thread holds words ks * 8 + tig (b0) and ks * 8 + 4 + tig (b1)
    uint32_t b[8];
    uint32_t b_hi = 0;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int w = ks * 8 + h * 4 + tig;
        uint64_t v = 0;
        if (slot < nb && w < wc) v = (uint64_t)sb[(size_t)slot * W + w0 + w];
        b[ks * 2 + h] = (uint32_t)v;
        b_hi |= (uint32_t)(v >> 32);
      }
    }
    // the barrier after staging, and the verdicts on the chunk: the
    // block's query words, then the warp's slot words
    const bool wide_a = __syncthreads_or(hi != 0);
    const bool wide = __any_sync(0xffffffffu, wide_a || b_hi != 0);
    if (!wide) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if (ks * 8 >= wc) break;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const uint32_t a[4] = {s_a[m * 16 + g][ks * 8 + tig],
                                 s_a[m * 16 + g + 8][ks * 8 + tig],
                                 s_a[m * 16 + g][ks * 8 + 4 + tig],
                                 s_a[m * 16 + g + 8][ks * 8 + 4 + tig]};
          mma_and_popc(c[m], a, b[ks * 2], b[ks * 2 + 1]);
        }
      }
    } else {
      // a high half is set: all 64 bits, at this thread's output places
      // (fragment v: row g + 8 * (v / 2), slot 2 * tig + v % 2)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int i = min(i0 + m * 16 + g + (v / 2) * 8, na - 1);
          const int j = min(n0 + tig * 2 + v % 2, nb - 1);
          for (int w = w0; w < w0 + wc; ++w)
            c[m][v] += __popcll((unsigned long long)sa[(size_t)i * W + w] &
                                (unsigned long long)sb[(size_t)j * W + w]);
        }
      }
    }
    __syncthreads();      // the next chunk overwrites s_a
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + m * 16 + g + h * 8;
      const int j = n0 + tig * 2;
      if (i >= na) continue;
      int32_t* o = out + (size_t)i * nb + j;
      if (nb % 2 == 0 && j < nb) {     // then j + 1 < nb too
        *reinterpret_cast<int2*>(o) =
            make_int2(c[m][h * 2], c[m][h * 2 + 1]);
      } else {
        if (j < nb) o[0] = c[m][h * 2];
        if (j + 1 < nb) o[1] = c[m][h * 2 + 1];
      }
    }
  }
}

}  // namespace

// sa (na, W), sb (nb, W) int64, contiguous -> out (na, nb) int32.
// ceil(na / 64) at most 65535.  Returns cudaGetLastError() after the
// launch.
extern "C" int set_intersect_launch(const int64_t* sa, const int64_t* sb,
                                    int na, int nb, int W, int32_t* out,
                                    void* stream) {
  if (na < 1 || nb < 1 || W < 1 || (na + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((nb + kSlots - 1) / kSlots, (na + kRows - 1) / kRows);
  set_intersect_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      sa, sb, na, nb, W, out);
  return (int)cudaGetLastError();
}
