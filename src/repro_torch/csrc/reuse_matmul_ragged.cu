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
// lax.cond) when a row's live count overflows it. Here the walk is the
// cluster tile loop of reuse_tile.cuh, whose list of active k tiles is the
// row-block's front-compacted `idx[mb, 0:counts[mb]]`, read on the device as
// it is (no compaction, nothing past the count): a skipped tile costs no
// iteration, the budget never truncates the walk, and no fallback or
// device→host sync is needed; a row with count 0 passes prev_out through
// bitwise. The cluster size C ∈ {1, 2, 4, 8} that splits each tile's k
// tiles is the output-stationary kernel's, chosen on the host from the
// shape (`kernels/reuse_matmul.py` `k_split`). The budget stays in the
// sensor accounting only (ops.ragged_grid_steps, ops.budget_overflow),
// which keeps the reference's rules.
//
// Measured on an NVIDIA H100 80GB HBM3 (700.00 W) by chip_smoke.py, bf16,
// M = 8, skip 0, weights read from HBM: qwen3 mlp_in [8,5120]×[5120,51200]
// 0.1780 ms against a 0.1575 ms bound and 0.1827 ms for `torch.addmm`
// (before this design, one CTA per tile looping over its count on CUDA
// cores: 0.2509 against 0.1838); `nvcc -Xptxas -v` (sm_90a): bf16 72
// registers, f32 157, no spills.
#include "reuse_tile.cuh"

// delta [M, K], w [Kw, N] of row stride ldw >= N (both bf16 or both f32;
// K − block_k < Kw ≤ K, the rows past Kw read as zero; a model-axis
// shard's column panel of a wider weight), prev_out / out [M, N] f32,
// counts [M / block_m] and idx [M / block_m, idx_ld] int32 (idx_ld >= K /
// block_k). M % 8 == 0, K % block_k == 0, block_m % 8 == 0, block_k % 64
// == 0; w, N and ldw aligned to 16 bytes (checked by the wrapper); cluster
// in {1, 2, 4, 8}.
extern "C" int rt_reuse_matmul_ragged(const void* delta, const void* w,
                                      int dtype, const void* prev_out,
                                      const void* counts, const void* idx,
                                      int idx_ld, void* out, int M, int K,
                                      int Kw, int N, int ldw, int block_m,
                                      int block_k, int cluster, void* stream) {
  reuse::RaggedList list;
  list.counts = static_cast<const int*>(counts);
  list.idx = static_cast<const int*>(idx);
  list.idx_ld = idx_ld;
  list.gk = K / block_k;
  list.block_m = block_m;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return reuse::launch<__nv_bfloat16>(delta, w, prev_out, out, M, K, Kw,
                                        N, ldw, block_k, cluster, list, s);
  return reuse::launch<float>(delta, w, prev_out, out, M, K, Kw, N, ldw,
                              block_k, cluster, list, s);
}
