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
//    and the whole [block_m, N] output panel is carried in VMEM across a
//    sequential k axis: a TPU answer to the long-K, narrow-N sites this
//    dataflow serves (qwen3-32b mlp_out: K = 25600, N = 5120). On Hopper the
//    same shape wants K split across CTAs with the partial sums combined on
//    chip, in one launch:
//    - Cluster k split. A cluster of kCluster = 8 CTAs owns one (8-row,
//      128-column) output tile. Every rank reads the tile's mask row and
//      compacts the active k tiles into a list (ballot + popc per warp);
//      the list is cut into 64-row sub-steps and dealt to the ranks in
//      contiguous runs whose lengths differ by at most one, so the skip
//      leaves no rank with a long tail (at skip 0.78 of mlp_out, 22 active
//      tiles are 88 sub-steps, 11 a rank). A masked tile issues no copy
//      and no multiply-add.
//    - The ring. Each sub-step is one stage of a ring in shared memory: 64
//      weight rows × 128 columns (16 KB in bf16) and the 8 Δ rows of those
//      k, copied by 16-byte `cp.async`, kRing − 1 stages in flight while
//      one is computed (3 × 17 KB per CTA in bf16, 2-3 CTAs per SM).
//      Copies are issued for active sub-steps only.
//    - bf16 on the tensor cores, transposed: outᵀ[cols, 8] = Wᵀ[cols, k] ·
//      Δᵀ[k, 8], so the output columns fill the M slot of `mma.sync.m16n8k16`
//      and the 8 decode rows fill N = 8 (no row is padded). The A fragment
//      comes straight from the N-major weight stage by `ldmatrix.x4.trans`
//      (16-bit elements, so no byte permutes), B from the Δ rows [8, k] by
//      plain `ldmatrix`; f32 accumulation. Each warp owns 32 columns (two
//      m16 blocks). Both stages carry an XOR swizzle of the 16-byte chunk
//      index with row % 8, so the 8 rows one ldmatrix phase reads hit all
//      32 banks while every chunk stays aligned for `cp.async`.
//    - f32 operands stay IEEE f32 on the CUDA cores (never TF32): thread t
//      owns column t of the tile and all 8 rows, `fmaf` in k order.
//    - The reduction. Each rank leaves its [8, 128] f32 partial in its own
//      shared memory; after `cluster.sync()` rank r sums row r of the tile
//      over ranks 0..7 in that fixed order through distributed shared
//      memory, starting from prev_out, and writes it. No scratch in device
//      memory, no atomics: the result is bitwise the same from run to run.
//      A rank with no sub-steps adds zeros; an all-masked row (the same in
//      every rank of the cluster) copies prev_out through bitwise.
//    On an H100 80GB HBM3 (700 W) at mlp_out the kernel streams the weight
//    at about 86% of the byte bound at skip 0, level with one cuBLAS call
//    (`torch.addmm`), and at 0.7 of the bound at skip 0.78. A ring one stage
//    deeper or shallower, an L2 prefetch hint, an interleaved deal of the
//    sub-steps and per-row bulk copies (`cp.async.bulk`, mbarriers) were
//    measured beside it and were no faster.
//    `nvcc -Xptxas -v` (sm_90a): bf16 72 registers, f32 142, no spills;
//    dynamic shared memory 69,632 B (bf16) or 104,448 B (f32) + 4·gk for
//    the list.
#include <cooperative_groups.h>
#include <stdint.h>

#include "reuse_tile.cuh"

namespace cg = cooperative_groups;

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

namespace {

constexpr int kCluster = 8;      // CTAs that split one output tile's k range
constexpr int kInCols = 128;     // output columns per CTA
constexpr int kInThreads = 128;  // 4 warps
constexpr int kSubK = 64;        // k rows of one sub-step (one ring stage)
// rank r reduces and writes row r of the tile, one column per thread
static_assert(kCluster == kRows && kInThreads == kInCols, "reduction layout");

template <typename T>
struct InCfg {
  static constexpr int kVec = 16 / (int)sizeof(T);  // elements per chunk
  static constexpr int kWRow = kInCols * (int)sizeof(T);  // weight row bytes
  static constexpr int kDRow = kSubK * (int)sizeof(T);    // Δ row bytes
  static constexpr int kWBytes = kSubK * kWRow;
  static constexpr int kStageBytes = kWBytes + kRows * kDRow;
  // 3 stages in flight while one is computed in bf16 (69,632 B, so 3 CTAs
  // fit an SM); 2 in f32, whose stages are twice as large
  static constexpr int kRing = sizeof(T) == 2 ? 4 : 3;
  static constexpr int kRingBytes = kRing * kStageBytes;
  static_assert(kWRow / 16 >= 8 && kDRow / 16 >= 8, "swizzle spans 8 chunks");
  static_assert(kRows * kDRow / 16 <= kInThreads, "one Δ chunk a thread");
  static_assert(kRows * kInCols * 4 <= kRingBytes, "partial fits the ring");
  // the ring, then the list of active k tiles
  static int smem_bytes(int gk) { return kRingBytes + gk * (int)sizeof(int); }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 8 x 8 b16 matrices; lanes 8i .. 8i + 7 address the rows of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte offset of 16-byte chunk c of row r, in rows of `row_bytes`: the chunk
// index is XORed with r % 8
__device__ __forceinline__ int swz(int r, int c, int row_bytes) {
  return r * row_bytes + ((c ^ (r & 7)) << 4);
}

// One stage in bf16: acc[4c + q] is the m16n8 fragment of the warp's column
// block c: output column 32·warp + 16c + g (q = 0, 1) or + 8 (q = 2, 3),
// row 2t + q % 2 (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void stage_product(float (&acc)[8],
                                              const unsigned char* sw,
                                              const unsigned char* sd,
                                              __nv_bfloat16) {
  using C = InCfg<__nv_bfloat16>;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int i = lane / 8;  // the 8 x 8 matrix this lane addresses
  // B of k step s: Δ rows m = g, k 16s + 2t (+ 1) and + 8, from chunks 2s
  // and 2s + 1 of the Δ rows
  uint32_t b[2][4];
  ldsm_x4(b[0], sd + swz(lane % 8, i, C::kDRow));
  ldsm_x4(b[1], sd + swz(lane % 8, 4 + i, C::kDRow));
#pragma unroll
  for (int s = 0; s < kSubK / 16; ++s) {
    // A = Wᵀ (16 columns × 16 k): matrix i holds k 16s + 8(i / 2) .. + 7 of
    // columns + 8(i % 2) .. + 7, transposed out of the k-row stage
    const int r = 16 * s + 8 * (i / 2) + lane % 8;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      uint32_t a[4];
      ldsm_x4_trans(a, sw + swz(r, 4 * warp + 2 * c + i % 2, C::kWRow));
      mma_bf16(acc + 4 * c, a, b[s / 2][2 * (s % 2)],
               b[s / 2][2 * (s % 2) + 1]);
    }
  }
}

// One stage in f32, IEEE on the CUDA cores: acc[m] is row m of column
// threadIdx.x.
__device__ __forceinline__ void stage_product(float (&acc)[8],
                                              const unsigned char* sw,
                                              const unsigned char* sd, float) {
  using C = InCfg<float>;
  const int col = threadIdx.x;
#pragma unroll 4
  for (int k = 0; k < kSubK; k += 4) {
    float wv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wv[j] = *reinterpret_cast<const float*>(
          sw + swz(k + j, col / 4, C::kWRow) + 4 * (col % 4));
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const float4 d =
          *reinterpret_cast<const float4*>(sd + swz(m, k / 4, C::kDRow));
      acc[m] = fmaf(d.x, wv[0], acc[m]);
      acc[m] = fmaf(d.y, wv[1], acc[m]);
      acc[m] = fmaf(d.z, wv[2], acc[m]);
      acc[m] = fmaf(d.w, wv[3], acc[m]);
    }
  }
}

template <typename T>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kInThreads)
input_stationary_kernel(const T* __restrict__ delta, const T* __restrict__ w,
                        const float* __restrict__ prev_out,
                        const int* __restrict__ mask, float* __restrict__ out,
                        int K, int N, int block_m, int block_k) {
  using C = InCfg<T>;
  extern __shared__ __align__(128) unsigned char shm[];
  constexpr int kWarps = kInThreads / 32;
  __shared__ int warp_cnt[kWarps];
  const int gk = K / block_k;
  int* tiles = reinterpret_cast<int*>(shm + C::kRingBytes);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int m0 = blockIdx.y * kRows;
  const int n0 = blockIdx.x / kCluster * kInCols;
  // the output element this thread writes: row rank, column threadIdx.x;
  // its prev_out is read now, so the read's latency hides behind the loop
  const size_t o = (size_t)(m0 + rank) * N + n0 + threadIdx.x;
  const float prev = prev_out[o];

  // 1. compact the tile's mask row into the list of active k tiles: every
  // thread reads one entry a round, and each warp places its active tiles
  // after those of the warps before it (ballot + popc)
  const int* mrow = mask + (size_t)(m0 / block_m) * gk;
  int n_active = 0;
  for (int base = 0; base < gk; base += kInThreads) {
    const int kt = base + threadIdx.x;
    const bool on = kt < gk && mrow[kt] != 0;
    const unsigned bal = __ballot_sync(0xffffffffu, on);
    if (lane == 0) warp_cnt[warp] = __popc(bal);
    __syncthreads();
    int pos = n_active + __popc(bal & ((1u << lane) - 1u));
    for (int q = 0; q < kWarps; ++q) {
      pos += q < warp ? warp_cnt[q] : 0;
      n_active += warp_cnt[q];
    }
    if (on) tiles[pos] = kt;
    __syncthreads();  // the list is whole; warp_cnt may be rewritten
  }
  if (n_active == 0) {  // the same in every rank: no reduction
    out[o] = prev;
    return;
  }

  // 2. this rank's run of sub-steps: [s0, s0 + ns) of the list's
  // n_active · spt, cut into kCluster runs whose lengths differ by <= 1
  const int spt = block_k / kSubK;
  const int total = n_active * spt;
  const int s0 = rank * total / kCluster;
  const int ns = (rank + 1) * total / kCluster - s0;

  auto load_stage = [&](int slot, int st) {
    const int s = s0 + st;
    const int k0 = tiles[s / spt] * block_k + (s % spt) * kSubK;
    unsigned char* sw = shm + slot * C::kStageBytes;
    unsigned char* sd = sw + C::kWBytes;
    constexpr int kRowChunks = C::kWRow / 16;
#pragma unroll
    for (int q = 0; q < kSubK * kRowChunks / kInThreads; ++q) {
      const int e = threadIdx.x + q * kInThreads;
      const int r = e / kRowChunks, c = e % kRowChunks;
      cp_async16(sw + swz(r, c, C::kWRow),
                 w + (size_t)(k0 + r) * N + n0 + c * C::kVec);
    }
    constexpr int kDChunks = C::kDRow / 16;
    if (threadIdx.x < kRows * kDChunks) {
      const int m = threadIdx.x / kDChunks, c = threadIdx.x % kDChunks;
      cp_async16(sd + swz(m, c, C::kDRow),
                 delta + (size_t)(m0 + m) * K + k0 + c * C::kVec);
    }
  };

  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
#pragma unroll
  for (int p = 0; p < C::kRing - 1; ++p) {
    if (p < ns) load_stage(p, p);
    cp_async_commit();
  }
  for (int st = 0; st < ns; ++st) {
    cp_async_wait<C::kRing - 2>();
    __syncthreads();  // stage st has landed; slot st - 1 is free again
    if (st + C::kRing - 1 < ns)
      load_stage((st + C::kRing - 1) % C::kRing, st + C::kRing - 1);
    cp_async_commit();
    const unsigned char* sw = shm + (st % C::kRing) * C::kStageBytes;
    stage_product(acc, sw, sw + C::kWBytes, T());
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring

  // 3. this rank's partial [kRows][kInCols] f32, over the ring
  float* part = reinterpret_cast<float*>(shm);
  if constexpr (sizeof(T) == 2) {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int n = 32 * warp + 16 * c + g;
      part[(2 * t) * kInCols + n] = acc[4 * c];
      part[(2 * t + 1) * kInCols + n] = acc[4 * c + 1];
      part[(2 * t) * kInCols + n + 8] = acc[4 * c + 2];
      part[(2 * t + 1) * kInCols + n + 8] = acc[4 * c + 3];
    }
  } else {
#pragma unroll
    for (int m = 0; m < kRows; ++m) part[m * kInCols + threadIdx.x] = acc[m];
  }
  cluster.sync();  // every rank's partial is in its shared memory
  float v = prev;
#pragma unroll
  for (int q = 0; q < kCluster; ++q)
    v += cluster.map_shared_rank(part, q)[rank * kInCols + threadIdx.x];
  out[o] = v;
  cluster.sync();  // no CTA leaves while a peer still reads its partial
}

}  // namespace

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
                                void* out, int M, int K, int N, int block_m,
                                int block_k, cudaStream_t stream) {
  const int smem = InCfg<T>::smem_bytes(K / block_k);
  static int granted = 0;
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        input_stationary_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    granted = smem;
  }
  dim3 grid(N / kInCols * kCluster, M / kRows);
  input_stationary_kernel<T><<<grid, kInThreads, smem, stream>>>(
      static_cast<const T*>(delta), static_cast<const T*>(w),
      static_cast<const float*>(prev_out), static_cast<const int*>(mask),
      static_cast<float*>(out), K, N, block_m, block_k);
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

// delta [M, K], w [K, N] (both bf16 or both f32), prev_out / out [M, N] f32,
// mask [M / block_m, K / block_k] int32. M % 8 == 0, N % 128 == 0,
// block_m % 8 == 0, block_k % 64 == 0 (checked by the wrapper). One launch
// of (N / 128) · 8 × M / 8 CTAs in clusters of 8; no scratch.
extern "C" int rt_reuse_matmul_input(const void* delta, const void* w,
                                     int dtype, const void* prev_out,
                                     const void* mask, void* out, int M, int K,
                                     int N, int block_m, int block_k,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_input<__nv_bfloat16>(delta, w, prev_out, mask, out, M, K, N,
                                       block_m, block_k, s);
  return launch_input<float>(delta, w, prev_out, mask, out, M, K, N, block_m,
                             block_k, s);
}
