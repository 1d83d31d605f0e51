// Block-skip ΔW GEMM, both dataflows: O = prev_out + Σ_k mask[m,k]·Δ[m,k]·W[k,n].
//
// Replaces: src/repro/kernels/reuse_matmul.py, `reuse_matmul`
//   (`_kernel_output_stationary` and `_kernel_input_stationary`).
//
// Bound on the H100: bytes. At decode M ≤ 8, so each weight byte feeds about
// 8 FLOP against the ~295 FLOP/byte ridge of the card: the time is the
// active weight tiles streamed from HBM (3.35 TB/s). A masked tile must cost
// neither its weight load nor its FMAs — that is the paper's mechanism.
//
// Design.
//  * Output-stationary. On the TPU the k grid axis runs in order and the
//    accumulator is carried across it in VMEM; a masked step repeats the
//    block index so no DMA is issued. Hopper CTAs run in no order and share
//    nothing, so one CTA owns an (8-row, 128-column) output tile and loops
//    over k itself: it reads mask[m,k] before it issues any load of that
//    tile, so a masked k costs one integer read. Weight rows are streamed as
//    16-byte coalesced loads, kChunkRows per thread in flight, and reduced
//    across row groups in shared memory at the end; the sum starts from
//    prev_out. f32 accumulation on CUDA cores (reuse_tile.cuh).
//  * Input-stationary. On the TPU the Δ tile stays resident while n sweeps,
//    and the whole [block_m, N] output panel is read-modified-written in
//    VMEM scratch across the sequential k axis. Here one CTA per active
//    (m-tile, k-tile, column range) keeps its Δ tile in shared memory and
//    sweeps 256·(16/sizeof(T)) columns with every thread owning its own
//    columns (no cross-thread reduction). Nothing carries over between CTAs,
//    so instead of an accumulator carried across k, each active k-tile
//    writes its partial product to an f32 scratch [gk, M, N], and a second
//    pass sums the active partials in increasing k from prev_out. That keeps
//    the result deterministic (no atomics) at the cost of one extra write
//    and read of M·N f32 per active k-tile — small next to the weights at
//    decode (M = 8). Masked tiles write no partial and are never read.
#include "reuse_tile.cuh"

using reuse::kRows;
using reuse::kThreads;
using reuse::kChunkRows;

template <typename T>
__global__ void __launch_bounds__(kThreads)
output_stationary_kernel(const T* __restrict__ delta, const T* __restrict__ w,
                         const float* __restrict__ prev_out,
                         const int* __restrict__ mask, float* __restrict__ out,
                         int K, int N, int block_m, int block_k) {
  using Tile = reuse::OutputTile<T>;
  __shared__ typename Tile::Smem smem;
  const int m0 = blockIdx.y * kRows;
  const int n0 = blockIdx.x * Tile::kCols;
  const int gk = K / block_k;
  const int* mrow = mask + (size_t)(m0 / block_m) * gk;
  Tile tile;
  for (int kt = 0; kt < gk; ++kt) {
    if (mrow[kt] == 0) continue;  // skipped tile: no weight load, no FMA
    tile.add_ktile(smem, delta, w, K, N, m0, n0, kt * block_k, block_k);
  }
  __syncthreads();
  tile.finish(smem, prev_out, out, N, m0, n0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
input_stationary_partial_kernel(const T* __restrict__ delta,
                                const T* __restrict__ w,
                                const int* __restrict__ mask,
                                float* __restrict__ partial, int M, int K,
                                int N, int block_m, int block_k) {
  constexpr int kVec = reuse::Vec<T>::n;
  extern __shared__ float d_s[];  // [kRows][block_k]: the resident Δ tile
  const int m0 = blockIdx.z * kRows;
  const int kt = blockIdx.y;
  const int gk = K / block_k;
  if (mask[(size_t)(m0 / block_m) * gk + kt] == 0) return;  // skipped tile
  const int k0 = kt * block_k;
  for (int e = threadIdx.x; e < kRows * block_k; e += kThreads) {
    const int m = e / block_k, r = e % block_k;
    d_s[e] = reuse::to_f32(delta[(size_t)(m0 + m) * K + k0 + r]);
  }
  __syncthreads();
  const int col = (blockIdx.x * kThreads + threadIdx.x) * kVec;
  if (col >= N) return;
  float acc[kRows][kVec];
#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[m][j] = 0.f;
  const T* wp = w + (size_t)k0 * N + col;
  for (int r0 = 0; r0 < block_k; r0 += kChunkRows) {
    uint4 buf[kChunkRows];
#pragma unroll
    for (int i = 0; i < kChunkRows; ++i)
      buf[i] = r0 + i < block_k
                   ? *reinterpret_cast<const uint4*>(wp + (size_t)(r0 + i) * N)
                   : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int i = 0; i < kChunkRows; ++i) {
      if (r0 + i >= block_k) break;
      float wf[kVec];
      reuse::unpack(buf[i], wf);
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        const float d = d_s[m * block_k + r0 + i];
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc[m][j] = fmaf(d, wf[j], acc[m][j]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    float* p = partial + ((size_t)kt * M + m0 + m) * N + col;
#pragma unroll
    for (int j = 0; j < kVec; j += 4)
      *reinterpret_cast<float4*>(p + j) =
          make_float4(acc[m][j], acc[m][j + 1], acc[m][j + 2], acc[m][j + 3]);
  }
}

// out[m, n] = prev_out[m, n] + Σ_{k active, increasing} partial[k, m, n].
__global__ void __launch_bounds__(kThreads)
input_stationary_reduce_kernel(const float* __restrict__ partial,
                               const float* __restrict__ prev_out,
                               const int* __restrict__ mask,
                               float* __restrict__ out, int M, int N, int gk,
                               int block_m) {
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (size_t)M * N) return;
  const int m = (int)(e / N);
  const int* mrow = mask + (size_t)(m / block_m) * gk;
  float v = prev_out[e];
  for (int kt = 0; kt < gk; ++kt)
    if (mrow[kt] != 0) v += partial[(size_t)kt * M * N + e];
  out[e] = v;
}

template <typename T>
static cudaError_t launch_output(const void* delta, const void* w,
                                 const void* prev_out, const void* mask,
                                 void* out, int M, int K, int N, int block_m,
                                 int block_k, cudaStream_t stream) {
  dim3 grid(N / reuse::OutputTile<T>::kCols, M / kRows);
  output_stationary_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(delta), static_cast<const T*>(w),
      static_cast<const float*>(prev_out), static_cast<const int*>(mask),
      static_cast<float*>(out), K, N, block_m, block_k);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_input(const void* delta, const void* w,
                                const void* prev_out, const void* mask,
                                void* partial, void* out, int M, int K, int N,
                                int block_m, int block_k, cudaStream_t stream) {
  constexpr int cols_per_cta = kThreads * reuse::Vec<T>::n;
  const int gk = K / block_k;
  dim3 grid((N + cols_per_cta - 1) / cols_per_cta, gk, M / kRows);
  const size_t smem = sizeof(float) * kRows * block_k;
  input_stationary_partial_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(delta), static_cast<const T*>(w),
      static_cast<const int*>(mask), static_cast<float*>(partial), M, K, N,
      block_m, block_k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)M * N;
  input_stationary_reduce_kernel<<<(unsigned)((total + kThreads - 1) / kThreads),
                                   kThreads, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<const float*>(prev_out),
      static_cast<const int*>(mask), static_cast<float*>(out), M, N, gk,
      block_m);
  return cudaGetLastError();
}

extern "C" int rt_reuse_matmul_output(const void* delta, const void* w,
                                      int dtype, const void* prev_out,
                                      const void* mask, void* out, int M, int K,
                                      int N, int block_m, int block_k,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_output<__nv_bfloat16>(delta, w, prev_out, mask, out, M, K, N,
                                        block_m, block_k, s);
  return launch_output<float>(delta, w, prev_out, mask, out, M, K, N, block_m,
                              block_k, s);
}

extern "C" int rt_reuse_matmul_input(const void* delta, const void* w,
                                     int dtype, const void* prev_out,
                                     const void* mask, void* partial, void* out,
                                     int M, int K, int N, int block_m,
                                     int block_k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_input<__nv_bfloat16>(delta, w, prev_out, mask, partial, out,
                                       M, K, N, block_m, block_k, s);
  return launch_input<float>(delta, w, prev_out, mask, partial, out, M, K, N,
                             block_m, block_k, s);
}
