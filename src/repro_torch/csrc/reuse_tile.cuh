// The cluster tile loop shared by the three float block-skip ΔW GEMMs
// (output- and input-stationary in reuse_matmul.cu, ragged in
// reuse_matmul_ragged.cu):
//
//   O = prev_out + Σ_{k tile in the list} Δ[m, k] · W[k, n]      f32 sum
//
// Decode has M = serving batch ≤ 8 rows, so each weight byte feeds about 8
// FLOP against the ~295 the H100 needs before its tensor cores become the
// limit: the time is the active weight tiles streamed from HBM. The kernels
// differ only in where a tile's list of active k tiles comes from (`List`:
// the mask row compacted, or the ragged `idx` row read as it is) and in the
// k split the host picks for the shape (the cluster size, 1, 2, 4 or 8).
//
//  * One cluster of C CTAs owns one (8-row, 128-column) output tile. The
//    list is cut into 64-row sub-steps, dealt to the C ranks in contiguous
//    runs whose lengths differ by at most one. A tile not in the list issues
//    no copy and no multiply-add; an empty list (the same in every rank)
//    copies prev_out through bitwise.
//  * The ring. A sub-step is one stage in shared memory: 64 weight rows ×
//    128 columns and the 8 Δ rows of those k, copied by 16-byte `cp.async`,
//    kRing − 1 stages in flight while one is computed. Both stages carry an
//    XOR swizzle of the 16-byte chunk index with row % 8, so the 8 rows one
//    `ldmatrix` phase reads hit all 32 banks while every chunk stays aligned
//    for `cp.async`.
//  * bf16 on the tensor cores, transposed: outᵀ[cols, 8] = Wᵀ[cols, k] ·
//    Δᵀ[k, 8], so the output columns fill the M slot of `mma.sync.m16n8k16`
//    and the 8 decode rows fill N = 8 (no row padded). A comes from the
//    N-major weight stage by `ldmatrix.x4.trans`, B from the Δ rows by plain
//    `ldmatrix`; f32 accumulation. Each of the 4 warps owns 32 columns.
//  * f32 operands stay IEEE f32 on the CUDA cores (never TF32): thread t
//    owns column t of the tile and all 8 rows, `fmaf` in k order.
//  * The K tail. Δ comes padded to whole block_k tiles (its padded columns
//    are zero), but the weight keeps its Kw ≤ K rows: a stage row k ≥ Kw is
//    zero-filled by its `cp.async` (source size 0) and never read, so no
//    call pads or copies the weight.
//  * Column panels and the N tail. The weight is read with its own row
//    stride `ldw` (≥ N), so one model-axis shard's panel `w[:, s·N:(s+1)·N]`
//    of an unsplit [K, S·N] weight is read in place. N need not be a
//    multiple of 128: the last tile column zero-fills the weight chunks past
//    N (`cp.async` of source size 0), reads no prev_out there and writes
//    nothing. A 16-byte chunk never straddles N (N % (16 / sizeof(T)) == 0,
//    checked by the wrappers with the alignment of the panel's base and
//    row stride). The k split comes from the unsharded site's N, so each
//    output element is summed in the same order whatever panel holds it.
//  * The reduction. Each rank leaves its [8, 128] f32 partial in its own
//    shared memory; rank r then sums rows r·8/C .. (r + 1)·8/C − 1 of the
//    tile over ranks 0 .. C − 1 in that order, through distributed shared
//    memory when C > 1, starting from prev_out, and writes them. No scratch
//    in device memory and no atomics: the result is bitwise the same from
//    run to run.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace reuse {

namespace cg = cooperative_groups;

constexpr int kRows = 8;       // output rows of a tile (one decode m tile)
constexpr int kCols = 128;     // output columns of a tile
constexpr int kThreads = 128;  // 4 warps; thread t writes column t
constexpr int kWarps = kThreads / 32;
constexpr int kSubK = 64;      // k rows of one sub-step (one ring stage)
static_assert(kThreads == kCols, "one output column a thread");

template <typename T>
struct Cfg {
  static constexpr int kVec = 16 / (int)sizeof(T);  // elements per chunk
  static constexpr int kWRow = kCols * (int)sizeof(T);  // weight row bytes
  static constexpr int kDRow = kSubK * (int)sizeof(T);  // Δ row bytes
  static constexpr int kWBytes = kSubK * kWRow;
  static constexpr int kStageBytes = kWBytes + kRows * kDRow;
  // 2 stages in flight while one is computed: 52,224 B in bf16, so 4 CTAs
  // fit an SM; 104,448 B in f32
  static constexpr int kRing = 3;
  static constexpr int kRingBytes = kRing * kStageBytes;
  static_assert(kWRow / 16 >= 8 && kDRow / 16 >= 8, "swizzle spans 8 chunks");
  static_assert(kRows * kDRow / 16 <= kThreads, "one Δ chunk a thread");
  static_assert(kRows * kCols * 4 <= kRingBytes, "partial fits the ring");
  // the ring, then the list of active k tiles
  static int smem_bytes(int gk) { return kRingBytes + gk * (int)sizeof(int); }
};

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
  using C = Cfg<__nv_bfloat16>;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int i = lane / 8;  // the 8 x 8 matrix this lane addresses
  // B of k step s: Δ rows m = g, k 16s + 2t (+ 1) and + 8, from chunks 2s
  // and 2s + 1 of the Δ rows
  uint32_t b[2][4];
  ptx::ldsm_x4(b[0], sd + swz(lane % 8, i, C::kDRow));
  ptx::ldsm_x4(b[1], sd + swz(lane % 8, 4 + i, C::kDRow));
#pragma unroll
  for (int s = 0; s < kSubK / 16; ++s) {
    // A = Wᵀ (16 columns × 16 k): matrix i holds k 16s + 8(i / 2) .. + 7 of
    // columns + 8(i % 2) .. + 7, transposed out of the k-row stage
    const int r = 16 * s + 8 * (i / 2) + lane % 8;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      uint32_t a[4];
      ptx::ldsm_x4_trans(a, sw + swz(r, 4 * warp + 2 * c + i % 2, C::kWRow));
      ptx::mma_bf16(acc + 4 * c, a, b[s / 2][2 * (s % 2)],
                    b[s / 2][2 * (s % 2) + 1]);
    }
  }
}

// One stage in f32, IEEE on the CUDA cores: acc[m] is row m of column
// threadIdx.x.
__device__ __forceinline__ void stage_product(float (&acc)[8],
                                              const unsigned char* sw,
                                              const unsigned char* sd, float) {
  using C = Cfg<float>;
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

// The list of a tile: the tile's mask row compacted. Every thread reads one
// entry a round, and each warp places its active tiles after those of the
// warps before it (ballot + popc).
struct MaskList {
  const int* mask;  // [M / block_m, gk] int32
  int gk, block_m;

  __device__ __forceinline__ int build(int* tiles, int m0) const {
    __shared__ int warp_cnt[kWarps];
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int* mrow = mask + (size_t)(m0 / block_m) * gk;
    int n_active = 0;
    for (int base = 0; base < gk; base += kThreads) {
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
    return n_active;
  }
};

// The list of a tile: the first counts[mb] entries of the front-compacted
// idx row, read as they are (the entries past the count are never read).
struct RaggedList {
  const int* counts;  // [M / block_m]
  const int* idx;     // [M / block_m, idx_ld]
  int idx_ld, gk, block_m;

  __device__ __forceinline__ int build(int* tiles, int m0) const {
    const int mb = m0 / block_m;
    const int count = min(counts[mb], gk);
    const int* row = idx + (size_t)mb * idx_ld;
    for (int j = threadIdx.x; j < count; j += kThreads) tiles[j] = row[j];
    __syncthreads();
    return count;
  }
};

// delta [M, K], w [Kw, N] of row stride ldw (K − block_k < Kw ≤ K),
// prev_out / out [M, N] f32. The grid is (ceil(N / 128) · cluster, M / 8),
// launched in clusters of `cluster` CTAs along x (none when cluster == 1);
// block_k % 64 == 0.
template <typename T, typename List>
__global__ void __launch_bounds__(kThreads)
cluster_gemm(const T* __restrict__ delta, const T* __restrict__ w,
             const float* __restrict__ prev_out, float* __restrict__ out,
             int K, int Kw, int N, int ldw, int block_k, int cluster,
             List list) {
  using C = Cfg<T>;
  extern __shared__ __align__(128) unsigned char shm[];
  int* tiles = reinterpret_cast<int*>(shm + C::kRingBytes);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int rank = blockIdx.x % cluster;
  const int m0 = blockIdx.y * kRows;
  const int n0 = blockIdx.x / cluster * kCols;
  // this rank writes rows rank·rows .. + rows − 1 of the tile, column
  // threadIdx.x; their prev_out is read now, so the read's latency hides
  // behind the loop
  const int rows = kRows / cluster;
  // the column this thread writes; past N (the N tail) it writes nothing
  const bool col_in = n0 + (int)threadIdx.x < N;
  const int rows_in = col_in ? rows : 0;
  const size_t o = (size_t)(m0 + rank * rows) * N + n0 + threadIdx.x;
  float prev[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    prev[i] = i < rows_in ? prev_out[o + (size_t)i * N] : 0.f;

  const int n_active = list.build(tiles, m0);
  if (n_active == 0) {  // the same in every rank: no reduction
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      if (i < rows_in) out[o + (size_t)i * N] = prev[i];
    return;
  }

  // this rank's run of sub-steps: [s0, s0 + ns) of the list's n_active ·
  // spt, cut into `cluster` runs whose lengths differ by <= 1
  const int spt = block_k / kSubK;
  const int total = n_active * spt;
  const int s0 = rank * total / cluster;
  const int ns = (rank + 1) * total / cluster - s0;

  auto load_stage = [&](int slot, int st) {
    const int s = s0 + st;
    const int k0 = tiles[s / spt] * block_k + (s % spt) * kSubK;
    unsigned char* sw = shm + slot * C::kStageBytes;
    unsigned char* sd = sw + C::kWBytes;
    constexpr int kRowChunks = C::kWRow / 16;
#pragma unroll
    for (int q = 0; q < kSubK * kRowChunks / kThreads; ++q) {
      const int e = threadIdx.x + q * kThreads;
      const int r = e / kRowChunks, c = e % kRowChunks;
      const int col = n0 + c * C::kVec;
      const bool in = k0 + r < Kw && col < N;
      ptx::cp_async16_zfill(sw + swz(r, c, C::kWRow),
                            w + (in ? (size_t)(k0 + r) * ldw + col : 0), in);
    }
    constexpr int kDChunks = C::kDRow / 16;
    if (threadIdx.x < kRows * kDChunks) {
      const int m = threadIdx.x / kDChunks, c = threadIdx.x % kDChunks;
      ptx::cp_async16(sd + swz(m, c, C::kDRow),
                      delta + (size_t)(m0 + m) * K + k0 + c * C::kVec);
    }
  };

  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
#pragma unroll
  for (int p = 0; p < C::kRing - 1; ++p) {
    if (p < ns) load_stage(p, p);
    ptx::cp_async_commit();
  }
  for (int st = 0; st < ns; ++st) {
    ptx::cp_async_wait<C::kRing - 2>();
    __syncthreads();  // stage st has landed; slot st - 1 is free again
    if (st + C::kRing - 1 < ns)
      load_stage((st + C::kRing - 1) % C::kRing, st + C::kRing - 1);
    ptx::cp_async_commit();
    const unsigned char* sw = shm + (st % C::kRing) * C::kStageBytes;
    stage_product(acc, sw, sw + C::kWBytes, T());
  }
  ptx::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring

  // this rank's partial [kRows][kCols] f32, over the ring
  float* part = reinterpret_cast<float*>(shm);
  if constexpr (sizeof(T) == 2) {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int n = 32 * warp + 16 * c + g;
      part[(2 * t) * kCols + n] = acc[4 * c];
      part[(2 * t + 1) * kCols + n] = acc[4 * c + 1];
      part[(2 * t) * kCols + n + 8] = acc[4 * c + 2];
      part[(2 * t + 1) * kCols + n + 8] = acc[4 * c + 3];
    }
  } else {
#pragma unroll
    for (int m = 0; m < kRows; ++m) part[m * kCols + threadIdx.x] = acc[m];
  }
  if (cluster == 1) {  // no cluster was launched: the partial is the sum
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      if (col_in)
        out[o + (size_t)i * N] = prev[i] + part[i * kCols + threadIdx.x];
    return;
  }
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();  // every rank's partial is in its shared memory
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (i < rows_in) {
      float v = prev[i];
      for (int q = 0; q < cluster; ++q)
        v += cl.map_shared_rank(part, q)[(rank * rows + i) * kCols +
                                         threadIdx.x];
      out[o + (size_t)i * N] = v;
    }
  }
  cl.sync();  // no CTA leaves while a peer still reads its partial
}

// One launch of cluster_gemm<T, List>: grants the dynamic shared memory of
// the ring and the list (a cudaFuncSetAttribute per instance, repeated only
// when a larger list needs more), then launches in clusters of `cluster`.
template <typename T, typename List>
cudaError_t launch(const void* delta, const void* w, const void* prev_out,
                   void* out, int M, int K, int Kw, int N, int ldw,
                   int block_k, int cluster, const List& list,
                   cudaStream_t stream) {
  if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8)
    return cudaErrorInvalidValue;
  const int smem = Cfg<T>::smem_bytes(K / block_k);
  static int granted = 0;
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        cluster_gemm<T, List>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
    granted = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kCols - 1) / kCols * cluster, M / kRows, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, cluster_gemm<T, List>, static_cast<const T*>(delta),
      static_cast<const T*>(w), static_cast<const float*>(prev_out),
      static_cast<float*>(out), K, Kw, N, ldw, block_k, cluster, list);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace reuse
