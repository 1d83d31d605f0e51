// Int8 block-skip ΔW GEMM, exact in int32 (the paper's `mla8` analogue):
//
//   acc[m,n] = prev_acc[m,n] + Σ_k mask[m/bm, k/bk] · Δq[m,k] · Wq[k,n]
//
// Replaces: src/repro/kernels/reuse_matmul_int8.py, `reuse_matmul_int8`
//   (`_kernel`).
//
// Bound on the H100: bytes at decode. With M = 8 rows each int8 weight byte
// feeds 16 integer operations, against the ~590 operations per byte at which
// the int8 tensor cores (1,979 TOP/s) would become the limit. At M = 128 the
// work per byte grows sixteenfold and the CUDA cores this kernel uses become
// its limit; an int8 MMA (`mma.sync ... s8`) is later work.
//
// Design. As the output-stationary float kernel (reuse_tile.cuh): one CTA
// owns an (8-row, 128-column) output tile and loops over k itself, reading
// mask[m, k] before it issues any load of that tile, so a masked tile costs
// one integer read. Thread t covers 8 columns (one 8-byte load of int8
// weights) of weight rows r ≡ t / 16 (mod 16); the 16 row groups are folded
// in registers and shared memory at the end, and the sum starts from
// prev_acc. The grid puts the m tiles on x, so the CTAs that read the same
// weight columns run together and share those loads in L2. Integer sums are
// exact and order-free, so the result equals the plain version bit for bit.
// The sums are kept in uint32: wrap-around is defined there, and at the
// widths of this repository the true sum stays far inside int32
// (127²·14336 ≈ 2.3e8 per k-extent, plus prev_acc), so the int32 read of the
// result is the exact sum.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;        // output rows per CTA
constexpr int kThreads = 256;
constexpr int kCols = 128;      // output columns per CTA
constexpr int kVec = 8;         // int8 weights per 8-byte load
constexpr int kTpr = kCols / kVec;          // 16 threads per weight row
constexpr int kGroups = kThreads / kTpr;    // 16 row groups
constexpr int kChunkRows = 8;               // weight rows in flight per thread
constexpr int kChunk = kGroups * kChunkRows;  // 128 weight rows per chunk
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int byte_at(uint32_t x, int b) {
  return static_cast<int8_t>(x >> (8 * b));
}

__global__ void __launch_bounds__(kThreads)
reuse_matmul_int8_kernel(const int8_t* __restrict__ delta,
                         const int8_t* __restrict__ w,
                         const int* __restrict__ prev_acc,
                         const int* __restrict__ mask, int* __restrict__ out,
                         int K, int N, int block_m, int block_k) {
  __shared__ int d_s[kRows][kChunk];
  __shared__ uint32_t red[kWarps][kRows][kCols];
  const int m0 = blockIdx.x * kRows;
  const int n0 = blockIdx.y * kCols;
  const int col = (threadIdx.x % kTpr) * kVec;
  const int group = threadIdx.x / kTpr;
  const int gk = K / block_k;
  const int* mrow = mask + (size_t)(m0 / block_m) * gk;
  uint32_t acc[kRows][kVec];
#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[m][j] = 0u;

  for (int kt = 0; kt < gk; ++kt) {
    if (mrow[kt] == 0) continue;  // skipped tile: no weight load, no MAC
    const int k0 = kt * block_k;
    for (int c0 = 0; c0 < block_k; c0 += kChunk) {
      const int rows = min(kChunk, block_k - c0);
      __syncthreads();  // the previous chunk's Δ reads are done
      for (int e = threadIdx.x; e < kRows * kChunk; e += kThreads) {
        const int m = e / kChunk, r = e % kChunk;
        d_s[m][r] = r < rows ? (int)delta[(size_t)(m0 + m) * K + k0 + c0 + r]
                             : 0;
      }
      __syncthreads();
      uint2 buf[kChunkRows];
#pragma unroll
      for (int i = 0; i < kChunkRows; ++i) {
        const int r = group + i * kGroups;
        buf[i] = r < rows ? *reinterpret_cast<const uint2*>(
                                w + (size_t)(k0 + c0 + r) * N + n0 + col)
                          : make_uint2(0u, 0u);
      }
#pragma unroll
      for (int i = 0; i < kChunkRows; ++i) {
        const int r = group + i * kGroups;
        int wv[kVec];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          wv[b] = byte_at(buf[i].x, b);
          wv[4 + b] = byte_at(buf[i].y, b);
        }
#pragma unroll
        for (int m = 0; m < kRows; ++m) {
          const int d = d_s[m][r];
#pragma unroll
          for (int j = 0; j < kVec; ++j) acc[m][j] += (uint32_t)(d * wv[j]);
        }
      }
    }
  }

  // fold the two row groups of each warp (lanes l and l ^ 16), then the warps
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], 16);
  if (lane < kTpr) {
#pragma unroll
    for (int m = 0; m < kRows; ++m)
#pragma unroll
      for (int j = 0; j < kVec; ++j) red[warp][m][col + j] = acc[m][j];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kRows * kCols; e += kThreads) {
    const int m = e / kCols, c = e % kCols;
    const size_t o = (size_t)(m0 + m) * N + n0 + c;
    uint32_t v = (uint32_t)prev_acc[o];
#pragma unroll
    for (int q = 0; q < kWarps; ++q) v += red[q][m][c];
    out[o] = (int)v;
  }
}

}  // namespace

// delta [M, K] int8, w [K, N] int8, prev_acc / out [M, N] int32, mask
// [M / block_m, K / block_k] int32. M % 8 == 0, N % 128 == 0, block_m % 8 == 0
// (checked by the wrapper).
extern "C" int rt_reuse_matmul_int8(const void* delta, const void* w,
                                    const void* prev_acc, const void* mask,
                                    void* out, int M, int K, int N,
                                    int block_m, int block_k, void* stream) {
  dim3 grid(M / kRows, N / kCols);
  reuse_matmul_int8_kernel<<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(delta), static_cast<const int8_t*>(w),
      static_cast<const int*>(prev_acc), static_cast<const int*>(mask),
      static_cast<int*>(out), K, N, block_m, block_k);
  return cudaGetLastError();
}
