// Block-skip ΔW GEMM, both dataflows: O = prev_out + Σ_k mask[m,k]·Δ[m,k]·W[k,n].
//
// Replaces: src/repro/kernels/reuse_matmul.py, `reuse_matmul`
//   (`_kernel_output_stationary` and `_kernel_input_stationary`).
//
// Bound on the H100: bytes. At decode M ≤ 8, so each weight byte feeds about
// 8 FLOP against the ~295 FLOP/byte ridge of the card: the time is the
// active weight tiles streamed from HBM (3.35 TB/s). A masked tile must cost
// neither its weight load nor its multiply-adds — that is the paper's
// mechanism.
//
// Design. On the TPU both dataflows carry their accumulator across a
// sequential k grid axis in VMEM: output-stationary per output tile,
// input-stationary per [block_m, N] panel while the Δ tile stays resident.
// Hopper CTAs run in no order and share nothing, and one (8-row,
// 128-column) output tile per CTA gives a 4096-wide site only 32 CTAs for
// 132 SMs. So both dataflows run one kernel, the cluster tile loop of
// reuse_tile.cuh: a cluster of C CTAs splits each tile's active k tiles
// (the tile's mask row compacted, ballot + popc) in 64-row sub-steps, each
// rank streams its run through a `cp.async` ring onto bf16 `mma.sync`
// (f32 operands: IEEE `fmaf`), and the ranks' partials are summed in rank
// order through distributed shared memory, starting from prev_out. The two
// entry points differ only in C:
//  * output-stationary: C ∈ {1, 2, 4, 8} from the shape alone, chosen on
//    the host (`kernels/reuse_matmul.py` `k_split`: the smallest C whose
//    (N / 128) · (M / 8) · C CTAs give 7/8 of the SMs a CTA, at most the
//    tile's 64-row sub-steps) — the active count lives on the device and is
//    never read. On the card one CTA an SM already streams at the HBM rate,
//    and every further split adds its own ring fill and reduction: at the
//    4096 → 4096 rwkv6 sites C = 4 (128 CTAs) and C = 8 take the same time,
//    C = 2 a quarter more; qwen3 mlp_in runs at C = 1 (400 CTAs, one wave
//    at the 4 CTAs an SM the 52 KB ring leaves room for; a 4-stage ring
//    fits 3, and the 4 CTAs of the second wave made it slower);
//  * input-stationary: C = 8, its geometry since it was redesigned (qwen3
//    mlp_out, K = 25600, N = 5120: 320 CTAs), bitwise the same results.
//    Its instance is a type of its own (InputList), so a profile names the
//    two apart.
// Measured on an NVIDIA H100 80GB HBM3 (700.00 W) by chip_smoke.py, bf16,
// M = 8, skip 0, weights read from HBM. Output-stationary: qwen3 mlp_in
// [8,5120]×[5120,51200] 0.1783 ms against a 0.1575 ms bound and 0.1827 ms
// for `torch.addmm` (before this design, one CTA per tile over all of k on
// CUDA cores: 0.2507 against 0.1838); rwkv6 4096 → 4096 0.0164 ms (bound
// 0.0101, `torch.addmm` 0.0164; before: 0.092 in a decode step),
// 4096 → 14336 0.0436 and 14336 → 4096 0.0437 (bounds 0.0354, 0.0352).
// Input-stationary at mlp_out: 0.0922 and 0.0952 ms in two runs (bound
// 0.0785, `torch.addmm` 0.0906 and 0.0917 in the same runs).
// `nvcc -Xptxas -v` (sm_90a): bf16 72 registers, f32 138, no spills;
// dynamic shared memory 52,224 B (bf16) or 104,448 B (f32) + 4·gk for the
// list.
#include <stdint.h>

#include "reuse_tile.cuh"

namespace {

// the input-stationary kernel's list: the mask's, as a type of its own
struct InputList : reuse::MaskList {};

template <typename List>
int run(const void* delta, const void* w, int dtype, const void* prev_out,
        const void* mask, void* out, int M, int K, int N, int block_m,
        int block_k, int cluster, void* stream) {
  List list;
  list.mask = static_cast<const int*>(mask);
  list.gk = K / block_k;
  list.block_m = block_m;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return reuse::launch<__nv_bfloat16>(delta, w, prev_out, out, M, K, N,
                                        block_k, cluster, list, s);
  return reuse::launch<float>(delta, w, prev_out, out, M, K, N, block_k,
                              cluster, list, s);
}

}  // namespace

// delta [M, K], w [K, N] (both bf16 or both f32), prev_out / out [M, N] f32,
// mask [M / block_m, K / block_k] int32. M % 8 == 0, N % 128 == 0,
// block_m % 8 == 0, block_k % 64 == 0 (checked by the wrapper); cluster in
// {1, 2, 4, 8}. One launch of (N / 128) · cluster × M / 8 CTAs; no scratch.
extern "C" int rt_reuse_matmul_output(const void* delta, const void* w,
                                      int dtype, const void* prev_out,
                                      const void* mask, void* out, int M, int K,
                                      int N, int block_m, int block_k,
                                      int cluster, void* stream) {
  return run<reuse::MaskList>(delta, w, dtype, prev_out, mask, out, M, K, N,
                              block_m, block_k, cluster, stream);
}

// As rt_reuse_matmul_output, in clusters of 8.
extern "C" int rt_reuse_matmul_input(const void* delta, const void* w,
                                     int dtype, const void* prev_out,
                                     const void* mask, void* out, int M, int K,
                                     int N, int block_m, int block_k,
                                     void* stream) {
  return run<InputList>(delta, w, dtype, prev_out, mask, out, M, K, N,
                        block_m, block_k, 8, stream);
}
