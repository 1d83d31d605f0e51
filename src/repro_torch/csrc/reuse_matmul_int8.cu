// Int8 block-skip ΔW GEMM, exact in int32 (the paper's `mla8` analogue), on
// the int8 tensor cores:
//
//   acc[m,n] = prev_acc[m,n] + Σ_k mask[m/bm, k/bk] · Δq[m,k] · Wq[k,n]
//
// Replaces: src/repro/kernels/reuse_matmul_int8.py, `reuse_matmul_int8`
//   (`_kernel`).
//
// Bound on the H100: bytes at both shapes it serves. [128,4096]x[4096,14336]
// is 15.0 G integer operations, 0.0076 ms at the 1,979 TOP/s int8 peak,
// against 0.0221 ms to move its 74 MB (the 58.7 MB weight, Δ, prev_acc and
// out) at 3.35 TB/s; at M = 8 the operations are 16 times fewer. At M = 8
// the warp-level `mma.sync.m16n8k32 ... s8` is enough (the kernel runs at
// three quarters of the byte bound). At M = 128 it is not: measured on the
// card, that path stayed bound inside the SM (as slow with no weight loads
// at all), since `mma.sync` reaches only a fraction of the int8 peak on
// Hopper. So a 128-row tile goes through `wgmma` (m64n128k32, A from
// registers, B from shared memory), the only way to the full int8 rate.
//
// Design.
// - Transposed product, N in the MMA's M slot: outᵀ = Wqᵀ · Δqᵀ. The A
//   operand is output columns by k of Wqᵀ (16 × 32 for `mma.sync`, 64 × 32
//   for a warpgroup's `wgmma`), the B operand is k by rows of Δq (8 rows for
//   `mma.sync`, so M = 8 fills it with no padding; all 128 for `wgmma`). Δq
//   [M, K] row-major is already the K-major layout B takes: 4 consecutive k
//   of one row in one register, or, staged in the 128-byte swizzle, the
//   canonical K-major tile a `wgmma` descriptor reads.
// - The weight byte transpose. Int8 MMA takes only K-major operands and Wq is
//   N-major; `ldmatrix .trans` moves 16-bit units, so it cannot transpose
//   bytes alone. A W tile is staged in shared memory as it lies in device
//   memory (rows of k, 16-byte `cp.async`, coalesced). One `ldmatrix.x4
//   .trans` then gives each thread, from each of four 8-row matrices, two k
//   rows × two columns; its rows are addressed so that matrix pair (0, 1)
//   holds k 4t, 4t + 1 and 4t + 2, 4t + 3 of the thread's quad t, and two
//   `__byte_perm`s finish the 4 × 4 byte transpose: k 4t .. 4t + 3 of one
//   column in one register. One ldmatrix and four permutes build the A
//   fragment of one MMA, whose 16 rows are relabelled output columns (rows
//   g, g + 8 = columns 2g, 2g + 1 of a 16-column block), which the epilogue
//   writes back to their true n. The B fragments (Δ, natural k order) come
//   from plain `ldmatrix.x4`. The shared rows carry XOR swizzles on their
//   16-byte chunks, so every 8-row ldmatrix phase hits 32 distinct banks
//   while each chunk stays aligned for `cp.async`.
// - The skip. A CTA's m tile lies inside one block_m group, so it owns one
//   mask row. At entry one warp reads that row and compacts the active k
//   tiles (ballot + popc) into a list of 32-row k groups in shared memory;
//   the copy ring walks only that list. A masked tile issues no `cp.async`
//   and no MMA and leaves no bubble in the ring; an all-masked row writes
//   prev_acc through (the hi component of the overflow split, almost always).
// - Bytes in flight: a ring of 128-k stages (`cp.async.cg`, commit/wait
//   groups) keeps 3 stages in flight while one is computed (4 for a 128-row
//   tile). A CTA covers 8 rows × 64 columns (224 CTAs of 4 warps at M = 8
//   and N = 14336, which split each stage's four MMA steps and fold their
//   sums in shared memory at the end) or, when block_m % 128 == 0, 128 × 128
//   with two warpgroups (112 CTAs). k is not split across CTAs to fill the
//   other 20 SMs: on the card, the second wave of CTAs a split adds cost
//   more than it gained.
// - Exactness. The accumulators start from prev_acc and stay in s32, without
//   `.satfinite`; at the widths of this repository |Σ| <= 127²·K + |prev|
//   (2.3e8 at K = 14336) is far inside int32, so the result equals the plain
//   version bit for bit.
//
// `nvcc -Xptxas -v` (sm_90a), and the dynamic shared memory at K = 4096
// (ring + 1,024 alignment + the group list): 0 spills, 1 barrier each. The
// 128-row tile (wgmma): 128 registers, 165,380 B; the 8-row tile: 58
// registers, 38,404 B.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

using namespace ptx;

constexpr int kGroupK = 32;                // k of one MMA (m16n8k32)
constexpr int kStepK = 128;                // k of one ring stage
constexpr int kSteps = kStepK / kGroupK;   // MMA steps per stage

// The two CTA tiles. 8 rows × 64 columns (`mma.sync`): 4 warps, warp s
// takes MMA step s of every stage, folded at the end. 128 rows × 128
// columns (`wgmma`): two warpgroups of 64 columns; warp w of a warpgroup
// holds the A fragment of its columns 16w .. 16w + 15.
template <bool WGMMA>
struct Cfg {
  static constexpr int kThreads = WGMMA ? 256 : 128;
  static constexpr int kRows = WGMMA ? 128 : 8;  // output rows per CTA
  static constexpr int kCols = WGMMA ? 128 : 64;  // output columns per CTA
  static constexpr int kC = WGMMA ? 1 : 4;        // 16-column blocks a warp
  static constexpr int kMW = kRows / 8;           // m8 tiles a warp
  static constexpr int kWBytes = kStepK * kCols;  // weight bytes per stage
  static constexpr int kDBytes = kRows * kStepK;  // Δ bytes per stage
  static constexpr int kStageBytes = kWBytes + kDBytes;
  // ring slots: 3 stages in flight while one is computed (4 for the
  // 128-row tile, whose compute holds its slot longer)
  static constexpr int kRing = WGMMA ? 5 : 4;
  static constexpr int kRingBytes = kRing * kStageBytes;
  // the dynamic shared memory: ring, then the k group list and its count,
  // with room to align the ring to 1024 bytes (the wgmma swizzle atom)
  static int smem_bytes(int K) {
    return 1024 + kRingBytes + (K / kGroupK + 1) * (int)sizeof(int);
  }
};

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator registers across the wgmma
// pipeline (which would serialize the wgmmas)
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) asm volatile("" : "+r"(d[j][q])::"memory");
}
// shared-memory matrix descriptor of a K-major tile in the 128-byte swizzle:
// 8-row atoms of 128-byte rows, 1024 bytes apart (SBO); LBO unused
__device__ __forceinline__ uint64_t gmma_desc(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
// d[j][q] += A (64 × 32, registers) · B (32 × 128 from the descriptor)
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[16][4],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63},"
      " {%64,%65,%66,%67}, %68, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
        "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
        "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
        "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
        "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
        "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
        "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
        "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
        "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// byte offset of (k row r, column byte b) in a stage's weight tile: the
// 16-byte chunk is XORed with a function of r that differs across the 8 rows
// {0, 1, 4, 5, 8, 9, 12, 13} (+ 2, + 16) one ldmatrix phase reads
template <int COLS>
__device__ __forceinline__ int w_off(int r, int b) {
  const int f = COLS == 128 ? (((r >> 2) & 3) << 1) | (r & 1) : (r >> 2) & 3;
  return (r * COLS + b) ^ (f << 4);
}
// byte offset of (m row, k byte kb) in a stage's Δ tile
__device__ __forceinline__ int d_off(int m, int kb) {
  return (m * kStepK + kb) ^ ((m & 7) << 4);
}

template <bool WGMMA>
__global__ void __launch_bounds__(Cfg<WGMMA>::kThreads)
reuse_matmul_int8_kernel(const int8_t* __restrict__ delta,
                         const int8_t* __restrict__ w,
                         const int* __restrict__ prev_acc,
                         const int* __restrict__ mask, int* __restrict__ out,
                         int K, int N, int block_m, int block_k) {
  using C = Cfg<WGMMA>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  // the k of each active 32-row group, then their count
  int* groups = reinterpret_cast<int*>(smem + C::kRingBytes);
  int* n_groups = groups + K / kGroupK;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  // the k row (within an MMA step) this lane addresses for ldmatrix.trans:
  // matrix lane / 8 covers k half (lane / 16) and pair (lane / 8 % 2) of
  // every quad, so its rows 2t, 2t + 1 are k 4t + 2·pair + {0, 1}
  const int a_row = 16 * (lane / 16) + 4 * (lane % 8 / 2) +
                    2 * (lane / 8 % 2) + lane % 2;
  // 8-row tile: warp = the MMA step it takes; 128-row tile: warp cw of
  // warpgroup wn
  const int wn = WGMMA ? warp / 4 : 0;
  const int cw = WGMMA ? warp % 4 : 0;
  const int m0 = blockIdx.x * C::kRows;
  const int n0 = blockIdx.y * C::kCols + 64 * wn;
  const int gk = K / block_k, gpt = block_k / kGroupK;

  // acc[c][i][2h + mm]: output row m0 + 8i + 2t + mm, column
  // n0 + 16(cw + c) + 2g + h. The sum starts from prev_acc (in one warp).
  int acc[C::kC][C::kMW][4];
#pragma unroll
  for (int c = 0; c < C::kC; ++c)
#pragma unroll
    for (int i = 0; i < C::kMW; ++i)
#pragma unroll
      for (int mm = 0; mm < 2; ++mm) {
        int2 v = make_int2(0, 0);
        if (WGMMA || warp == 0)
          v = *reinterpret_cast<const int2*>(
              prev_acc + (size_t)(m0 + 8 * i + 2 * t + mm) * N + n0 +
              16 * (cw + c) + 2 * g);
        acc[c][i][mm] = v.x;
        acc[c][i][2 + mm] = v.y;
      }

  // 1. compact this CTA's mask row into the list of active 32-row k groups
  if (warp == 0) {
    const int* mrow = mask + (size_t)(m0 / block_m) * gk;
    int cnt = 0;
    for (int base = 0; base < gk; base += 32) {
      const int kt = base + lane;
      const bool on = kt < gk && mrow[kt] != 0;
      const unsigned bal = __ballot_sync(0xffffffffu, on);
      if (on) {
        const int p = (cnt + __popc(bal & ((1u << lane) - 1u))) * gpt;
        for (int j = 0; j < gpt; ++j) groups[p + j] = kt * block_k + j * kGroupK;
      }
      cnt += __popc(bal);
    }
    if (lane == 0) *n_groups = cnt * gpt;
  }
  __syncthreads();
  const int G = *n_groups;
  const int ns = (G + kSteps - 1) / kSteps;

  // 2. the ring: stage st holds k groups 4·st .. 4·st + 3 of the list
  auto load_stage = [&](int slot, int st) {
    unsigned char* sw = smem + slot * C::kStageBytes;
    unsigned char* sd = sw + C::kWBytes;
    constexpr int kWChunks = kStepK * C::kCols / 16;
    constexpr int kRowChunks = C::kCols / 16;
    const int nb = blockIdx.y * C::kCols;
#pragma unroll
    for (int q = 0; q < kWChunks / C::kThreads; ++q) {
      const int e = threadIdx.x + q * C::kThreads;
      const int r = e / kRowChunks, c = e % kRowChunks;
      const int gi = st * kSteps + r / kGroupK;
      if (gi < G)
        cp_async16(sw + w_off<C::kCols>(r, 16 * c),
                   w + (size_t)(groups[gi] + r % kGroupK) * N + nb + 16 * c);
    }
    constexpr int kDChunks = C::kRows * kStepK / 16;
#pragma unroll
    for (int q = 0; q < (kDChunks + C::kThreads - 1) / C::kThreads; ++q) {
      const int e = threadIdx.x + q * C::kThreads;
      const int m = e / (kStepK / 16), c = e % (kStepK / 16);
      const int gi = st * kSteps + c / 2;
      if (e < kDChunks && gi < G)
        cp_async16(sd + d_off(m, 16 * c),
                   delta + (size_t)(m0 + m) * K + groups[gi] + 16 * (c % 2));
    }
  };

#pragma unroll
  for (int p = 0; p < C::kRing - 1; ++p) {
    if (p < ns) load_stage(p, p);
    cp_async_commit();
  }
  for (int st = 0; st < ns; ++st) {
    cp_async_wait<C::kRing - 2>();
    if constexpr (WGMMA) fence_proxy_async();  // cp.async → wgmma reads
    __syncthreads();
    if (st + C::kRing - 1 < ns)
      load_stage((st + C::kRing - 1) % C::kRing, st + C::kRing - 1);
    cp_async_commit();

    const unsigned char* sw = smem + (st % C::kRing) * C::kStageBytes;
    const unsigned char* sd = sw + C::kWBytes;
    // A of MMA c: Wqᵀ rows g, g + 8 = columns 16c + 2g, 16c + 2g + 1. One
    // ldmatrix.trans gives each thread two k × two columns from each of four
    // 8-row matrices (rows ↦ k as a_row), and two byte permutes per pair of
    // matrices give k 4t .. 4t + 3 of one column in one register. A step
    // past the list's end (the ragged tail) gets a zero A.
    auto a_frag = [&](uint32_t (&a)[4], int s, int c, bool on) {
      uint32_t x[4] = {0u, 0u, 0u, 0u};
      if (on)
        ldsm_x4_trans(x, sw + w_off<C::kCols>(s * kGroupK + a_row,
                                              64 * wn + 16 * c));
      a[0] = __byte_perm(x[0], x[1], 0x6420);
      a[1] = __byte_perm(x[0], x[1], 0x7531);
      a[2] = __byte_perm(x[2], x[3], 0x6420);
      a[3] = __byte_perm(x[2], x[3], 0x7531);
    };
    if constexpr (WGMMA) {
      // the A fragments of the stage's 4 steps, then their wgmmas (a zero A
      // adds nothing, whatever the unloaded B of its step holds)
      const int steps = G - st * kSteps;  // CTA-uniform
      uint32_t a[kSteps][4];
#pragma unroll
      for (int s = 0; s < kSteps; ++s) a_frag(a[s], s, cw, s < steps);
      fence_regs(acc[0]);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
        wgmma_m64n128k32(acc[0], a[s], gmma_desc(sd + s * kGroupK));
      wgmma_commit();
      wgmma_wait_all();  // the ring slot is free again
      fence_regs(acc[0]);
    } else if (st * kSteps + warp < G) {  // warp-uniform: the ragged tail
      const int s = warp;
      uint32_t a[4][4], b[2];
#pragma unroll
      for (int c = 0; c < 4; ++c) a_frag(a[c], s, c, true);
      // B: the 8 rows of Δ, k 4t .. 4t + 3 (b[0]) and + 16 (b[1])
      ldsm_x2(b, sd + d_off(lane % 8, s * kGroupK + 16 * (lane / 8 % 2)));
#pragma unroll
      for (int c = 0; c < 4; ++c) mma_s8(acc[c][0], a[c], b[0], b[1]);
    }
  }

  // 3. the 8-row tile folds its 4 warps' sums; then the tile is written
  if constexpr (!WGMMA) {
    cp_async_wait<0>();
    __syncthreads();  // the ring is free: every stage was consumed
    int* fold = reinterpret_cast<int*>(smem) + lane * 16;
    if (warp > 0) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          fold[(warp - 1) * 32 * 16 + c * 4 + q] = acc[c][0][q];
    }
    __syncthreads();
    if (warp > 0) return;
#pragma unroll
    for (int f = 0; f < 3; ++f)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[c][0][q] += fold[f * 32 * 16 + c * 4 + q];
  }
#pragma unroll
  for (int c = 0; c < C::kC; ++c)
#pragma unroll
    for (int i = 0; i < C::kMW; ++i)
#pragma unroll
      for (int mm = 0; mm < 2; ++mm)
        *reinterpret_cast<int2*>(out + (size_t)(m0 + 8 * i + 2 * t + mm) * N +
                                 n0 + 16 * (cw + c) + 2 * g) =
            make_int2(acc[c][i][mm], acc[c][i][2 + mm]);
}

template <bool WGMMA>
int launch(const int8_t* delta, const int8_t* w, const int* prev_acc,
           const int* mask, int* out, int M, int K, int N, int block_m,
           int block_k, cudaStream_t stream) {
  using C = Cfg<WGMMA>;
  const int smem = C::smem_bytes(K);
  static int granted = 0;
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        reuse_matmul_int8_kernel<WGMMA>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    granted = smem;
  }
  dim3 grid(M / C::kRows, N / C::kCols);
  reuse_matmul_int8_kernel<WGMMA><<<grid, C::kThreads, smem, stream>>>(
      delta, w, prev_acc, mask, out, K, N, block_m, block_k);
  return cudaGetLastError();
}

}  // namespace

// delta [M, K] int8, w [K, N] int8, prev_acc / out [M, N] int32, mask
// [M / block_m, K / block_k] int32. M % block_m == 0, N % 128 == 0,
// block_m % 8 == 0, block_k % 32 == 0 (checked by the wrapper). A CTA's rows
// lie inside one block_m group: 128-row tiles (wgmma) when block_m % 128 ==
// 0, else 8-row tiles (mma.sync).
extern "C" int rt_reuse_matmul_int8(const void* delta, const void* w,
                                    const void* prev_acc, const void* mask,
                                    void* out, int M, int K, int N,
                                    int block_m, int block_k, void* stream) {
  const auto* d = static_cast<const int8_t*>(delta);
  const auto* wq = static_cast<const int8_t*>(w);
  const auto* p = static_cast<const int*>(prev_acc);
  const auto* mk = static_cast<const int*>(mask);
  auto* o = static_cast<int*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (block_m % 128 == 0)
    return launch<true>(d, wq, p, mk, o, M, K, N, block_m, block_k, s);
  return launch<false>(d, wq, p, mk, o, M, K, N, block_m, block_k, s);
}
