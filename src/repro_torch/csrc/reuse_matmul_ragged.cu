// Ragged compacted-grid ΔW GEMM: O = prev_out + Σ_{j < counts[m]} Δ[m, idx[m,j]]·W[idx[m,j], n].
//
// Replaces: src/repro/kernels/reuse_matmul_ragged.py, `reuse_matmul_ragged`
//   (`_kernel`).
//
// Bound on the H100: bytes — the active weight tiles streamed from HBM, as
// for the masked kernel (reuse_matmul.cu); at decode M ≤ 8 each weight byte
// feeds about 8 FLOP against a ridge of ~295.
//
// Design. The TPU kernel needs a static grid extent, so the policy picks a
// budget `max_active_k` and the wrapper falls back to the full extent (a
// lax.cond) when a row's live count overflows it. Here the k loop lives
// inside the CTA: one CTA per (8-row, 128-column) output tile reads its
// row-block's `counts[m]` on the device and walks exactly the front-compacted
// active k-tiles `idx[m, 0:counts[m]]`. A skipped tile costs no iteration at
// all, the budget never truncates the walk, and no fallback or device→host
// sync is needed; a row with count 0 passes prev_out through. The budget
// stays in the sensor accounting only (ops.ragged_grid_steps,
// ops.budget_overflow), which keeps the reference's rules.
#include "reuse_tile.cuh"

using reuse::kRows;
using reuse::kThreads;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ragged_kernel(const T* __restrict__ delta, const T* __restrict__ w,
              const float* __restrict__ prev_out, const int* __restrict__ counts,
              const int* __restrict__ idx, int idx_ld, float* __restrict__ out,
              int K, int N, int block_m, int block_k) {
  using Tile = reuse::OutputTile<T>;
  __shared__ typename Tile::Smem smem;
  const int m0 = blockIdx.y * kRows;
  const int n0 = blockIdx.x * Tile::kCols;
  const int mb = m0 / block_m;
  const int count = counts[mb];
  const int* row = idx + (size_t)mb * idx_ld;
  Tile tile;
  for (int j = 0; j < count; ++j)
    tile.add_ktile(smem, delta, w, K, N, m0, n0, row[j] * block_k, block_k);
  __syncthreads();
  tile.finish(smem, prev_out, out, N, m0, n0);
}

template <typename T>
static cudaError_t launch(const void* delta, const void* w,
                          const void* prev_out, const void* counts,
                          const void* idx, int idx_ld, void* out, int M, int K,
                          int N, int block_m, int block_k,
                          cudaStream_t stream) {
  dim3 grid(N / reuse::OutputTile<T>::kCols, M / kRows);
  ragged_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(delta), static_cast<const T*>(w),
      static_cast<const float*>(prev_out), static_cast<const int*>(counts),
      static_cast<const int*>(idx), idx_ld, static_cast<float*>(out), K, N,
      block_m, block_k);
  return cudaGetLastError();
}

extern "C" int rt_reuse_matmul_ragged(const void* delta, const void* w,
                                      int dtype, const void* prev_out,
                                      const void* counts, const void* idx,
                                      int idx_ld, void* out, int M, int K,
                                      int N, int block_m, int block_k,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(delta, w, prev_out, counts, idx, idx_ld, out,
                                 M, K, N, block_m, block_k, s);
  return launch<float>(delta, w, prev_out, counts, idx, idx_ld, out, M, K, N,
                       block_m, block_k, s);
}
