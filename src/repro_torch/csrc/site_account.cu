// A reuse site call's cache bookkeeping after its ΔW GEMM, in two launches:
//
//   rows:     partial[m, c] = #{k in chunk c : cur_q[m, k] == prev_q[m, k]},
//             then prev_q[m, k] = cur_q[m, k] (each element read, then written,
//             by the same thread)
//   epilogue: matches[m] = Σ_c partial[m, c]; sim_ema, slot_hit_sum and
//             slot_steps per row; one thread then steps, the ctrl occupancy
//             and the scalar sensor counters, from reductions of the tile
//             mask (its loads of those lanes issued first, all at once)
//
// Replaces: no TPU kernel. The reference computes these lanes in the jitted
// step around its kernels (src/repro/core/reuse_linear.py:222-264 and
// src/repro/sensor/counters.py:151-281), where XLA fuses them; run eagerly
// they were about a hundred small kernels a site call.
//
// Rounding. Every lane is bitwise the plain version's
// (kernels/site_account.site_account_torch). The three EMA-like lanes
// (sim_ema, occupancy, slot_hit_sum) are one FMA each, as the reference's
// compiled step contracts them: __fmaf_rn. Every counter product and add is
// rounded on its own, as the plain version's separate tensor ops are:
// __fmul_rn and __fadd_rn, which nvcc never contracts. No fast math, no
// flush to zero. The host passes every constant already rounded to f32.
// A NaN lane stays NaN; the card's FMA returns the canonical NaN where the
// plain version keeps the payload.
//
// Bound on the H100: bytes, and at decode sizes the launch. The row pass
// reads cur_q and prev_q and writes prev_q, 3·M·K bytes (0.61 MB at
// [8, 25600], 0.18 µs at 3.35 TB/s); the epilogue reads the [gm, gk] mask
// and a few hundred bytes of lanes. Both are far below the ~2 µs a launch
// costs, so the design is the simplest that is right: one CTA per (row,
// 4 KB chunk), 16-byte loads where the operands allow, and one CTA for the
// epilogue. A first version let one thread read and write each scalar lane
// in turn, ~8 µs an epilogue: each load waited for the store before it,
// through pointers that may alias; now every load is issued before any
// store (PERF.md §6). The budget is read from its device lane, so a captured graph
// reads the live value; nothing is allocated here (the wrapper's scratch).
#include <climits>
#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;

// kernels/site_account.PATHS
enum Path { kKernel = 0, kDense = 1, kRagged = 2, kCompact = 3 };

// the pointers, in the wrapper's order; a lane the entry lacks is null
struct Lanes {
  const int8_t* cur_q;
  int8_t* prev_q;
  int* partial;
  float* matches;
  const int* mask;
  const int* budget;
  float* sim_ema;
  int* steps;
  float* occupancy;
  int* skipped_tiles;
  int* computed_tiles;
  float* skipped_macs;
  float* computed_macs;
  float* skipped_weight_bytes;
  float* total_weight_bytes;
  float* reused_out_elems;
  int* dma_issued_tiles;
  float* grid_steps;
  int* overflow_fallbacks;
  int* mode_flag;
  int* mode_transitions;
  float* slot_hit_sum;
  int* slot_steps;
};
constexpr int kNumLanes = sizeof(Lanes) / sizeof(void*);
static_assert(sizeof(Lanes) == kNumLanes * sizeof(void*), "pointers only");

// kernels/site_account.INTS, in order
struct Ints {
  int m, k, ldq, chunks, vec, gm, gk, basic, path, output, shard_count,
      shard_index, g, total, grid_rate, budget, has_ctrl, has_sensor;
};
constexpr int kNumInts = sizeof(Ints) / sizeof(int);

// kernels/site_account.FLOATS, in order
struct Floats {
  float decay, c_sim, c_occ, inv_k, macs, tile_w, row_elems, total_macs,
      total_w, grid_full, grid_over, panels;
};
constexpr int kNumFloats = sizeof(Floats) / sizeof(float);

__device__ int block_sum(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) red[warp] = v;
  __syncthreads();
  int total = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) total += red[w];
  return total;  // on thread 0
}

__global__ void __launch_bounds__(kThreads)
site_account_rows(Lanes L, Ints g) {
  __shared__ int red[kThreads / 32];
  const int row = blockIdx.y;
  const int begin = blockIdx.x * kChunk;
  const int end = min(g.k, begin + kChunk);
  const int8_t* q = L.cur_q + (size_t)row * g.ldq;
  int8_t* p = L.prev_q + (size_t)row * g.k;
  int count = 0;
  if (g.vec) {  // k, ldq and both pointers are multiples of 16
    const uint4* q4 = reinterpret_cast<const uint4*>(q);
    uint4* p4 = reinterpret_cast<uint4*>(p);
    for (int i = begin / 16 + threadIdx.x; i < end / 16; i += kThreads) {
      const uint4 a = q4[i];
      const uint4 b = p4[i];
      // __vcmpeq4 sets 0xff in each equal byte: 8 bits a match
      count += (__popc(__vcmpeq4(a.x, b.x)) + __popc(__vcmpeq4(a.y, b.y)) +
                __popc(__vcmpeq4(a.z, b.z)) + __popc(__vcmpeq4(a.w, b.w))) >>
               3;
      p4[i] = a;
    }
  } else {
    for (int i = begin + threadIdx.x; i < end; i += kThreads) {
      const int8_t a = q[i];
      count += a == p[i];
      p[i] = a;
    }
  }
  count = block_sum(count, red);
  if (threadIdx.x == 0) L.partial[row * g.chunks + blockIdx.x] = count;
}

// the scalar lanes, read by one thread before any of them is written: the
// loads are independent and pipeline (one round trip), where a read after
// a write through another pointer that may alias would wait for each
struct Scalars {
  int steps;
  float occupancy;
  int skipped_tiles, computed_tiles;
  float skipped_macs, computed_macs, skipped_weight_bytes, total_weight_bytes,
      reused_out_elems;
  int dma_issued_tiles;
  float grid_steps;
  int overflow_fallbacks, mode_flag, mode_transitions, budget;
};

__device__ Scalars load_scalars(const Lanes& L, const Ints& g) {
  Scalars v{};
  v.steps = *L.steps;
  v.budget = L.budget != nullptr ? *L.budget : g.budget;
  if (g.has_ctrl) v.occupancy = *L.occupancy;
  if (g.has_sensor) {
    v.skipped_tiles = *L.skipped_tiles;
    v.computed_tiles = *L.computed_tiles;
    v.skipped_macs = *L.skipped_macs;
    v.computed_macs = *L.computed_macs;
    v.skipped_weight_bytes = *L.skipped_weight_bytes;
    v.total_weight_bytes = *L.total_weight_bytes;
    v.reused_out_elems = *L.reused_out_elems;
    v.dma_issued_tiles = *L.dma_issued_tiles;
    v.grid_steps = *L.grid_steps;
    v.overflow_fallbacks = *L.overflow_fallbacks;
    v.mode_flag = *L.mode_flag;
    v.mode_transitions = *L.mode_transitions;
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
site_account_epilogue(Lanes L, Ints g, Floats f) {
  // mask reductions: Σ mask, Σ over owned columns, nonzero tiles, nonzero
  // tiles at k >= 1, all-zero rows, Σ max(row count, 1), rows over the
  // budget, Σ of the column maxima
  enum { kSum, kOwn, kNnz, kNnzK1, kZeroRows, kClampSum, kOver, kLive, kRed };
  __shared__ int red[kRed];
  __shared__ int kb;
  Scalars v{};
  if (threadIdx.x == 0) {
    v = load_scalars(L, g);
    kb = v.budget;
  }
  if (threadIdx.x < kRed) red[threadIdx.x] = 0;
  __syncthreads();
  const bool sensor = g.has_sensor != 0;
  for (int m = threadIdx.x; m < g.m; m += kThreads) {
    int count = 0;
    for (int c = 0; c < g.chunks; ++c) count += L.partial[m * g.chunks + c];
    const float mt = (float)count;  // exact: count <= K < 2^24
    L.matches[m] = mt;
    L.sim_ema[m] = __fmaf_rn(L.sim_ema[m], f.decay, __fmul_rn(mt, f.c_sim));
    if (sensor) {
      L.slot_hit_sum[m] = __fmaf_rn(mt, f.inv_k, L.slot_hit_sum[m]);
      L.slot_steps[m] += 1;
    }
  }
  if (!g.basic) {
    int sum = 0, own = 0, nnz = 0, nnz_k1 = 0;
    for (int i = threadIdx.x; i < g.gm * g.gk; i += kThreads) {
      const int x = L.mask[i];
      const int col = i % g.gk;
      sum += x;
      if (g.shard_count == 0 || col % g.shard_count == g.shard_index) own += x;
      nnz += x != 0;
      nnz_k1 += col >= 1 && x != 0;
    }
    int zero_rows = 0, clamp_sum = 0, over = 0;
    for (int r = threadIdx.x; r < g.gm; r += kThreads) {
      int count = 0;
      for (int c = 0; c < g.gk; ++c) count += L.mask[r * g.gk + c] != 0;
      zero_rows += count == 0;
      clamp_sum += max(count, 1);
      over |= count > kb;
    }
    int live = 0;
    for (int c = threadIdx.x; c < g.gk; c += kThreads) {
      int mx = INT_MIN;
      for (int r = 0; r < g.gm; ++r) mx = max(mx, L.mask[r * g.gk + c]);
      live += mx;
    }
    atomicAdd(&red[kSum], sum);
    atomicAdd(&red[kOwn], own);
    atomicAdd(&red[kNnz], nnz);
    atomicAdd(&red[kNnzK1], nnz_k1);
    atomicAdd(&red[kZeroRows], zero_rows);
    atomicAdd(&red[kClampSum], clamp_sum);
    atomicOr(&red[kOver], over);
    atomicAdd(&red[kLive], live);
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  *L.steps = v.steps + 1;
  if (!g.basic && g.has_ctrl)
    *L.occupancy = __fmaf_rn(v.occupancy, f.decay,
                             __fmul_rn((float)red[kSum], f.c_occ));
  if (!sensor) return;
  const int flag = g.basic ? 0 : 1;
  if (g.basic) {
    // everything computed, every weight tile streamed
    *L.computed_tiles = v.computed_tiles + g.total;
    *L.computed_macs = __fadd_rn(v.computed_macs, f.total_macs);
    *L.total_weight_bytes = __fadd_rn(v.total_weight_bytes, f.total_w);
    *L.dma_issued_tiles = v.dma_issued_tiles + g.gm * g.gk * g.g;
    *L.grid_steps = __fadd_rn(v.grid_steps, f.grid_full);
  } else {
    const int own = red[kOwn];
    const int skipped = g.total - own;
    *L.skipped_tiles = v.skipped_tiles + skipped;
    *L.computed_tiles = v.computed_tiles + own;
    *L.skipped_macs =
        __fadd_rn(v.skipped_macs, __fmul_rn((float)skipped, f.macs));
    *L.computed_macs =
        __fadd_rn(v.computed_macs, __fmul_rn((float)own, f.macs));
    *L.skipped_weight_bytes = __fadd_rn(v.skipped_weight_bytes,
                                        __fmul_rn((float)skipped, f.tile_w));
    *L.total_weight_bytes = __fadd_rn(v.total_weight_bytes, f.total_w);
    *L.reused_out_elems =
        __fadd_rn(v.reused_out_elems,
                  __fmul_rn((float)red[kZeroRows], f.row_elems));
    int dma;
    float grid = f.grid_full;
    if (g.path == kRagged || g.path == kCompact) {
      // ragged: per-row counts against the budget; compact: the live
      // column count, every row's
      const int over = g.path == kRagged ? red[kOver] : red[kLive] > kb;
      dma = g.path == kRagged ? red[kClampSum] : red[kLive];
      grid = over ? f.grid_over : (float)(kb * g.grid_rate);
      if (g.shard_count != 0) grid = __fmul_rn(grid, f.panels);
      *L.overflow_fallbacks = v.overflow_fallbacks + over;
    } else {
      // output-stationary: one load at k = 0 and one at each sel
      // transition, which is each computed tile at k >= 1
      dma = g.output ? red[kNnzK1] + g.gm : red[kNnz];
    }
    *L.dma_issued_tiles = v.dma_issued_tiles + dma * g.g;
    *L.grid_steps = __fadd_rn(v.grid_steps, grid);
  }
  *L.mode_transitions = v.mode_transitions + (v.mode_flag >= 0 &&
                                              v.mode_flag != flag);
  *L.mode_flag = flag;
}

}  // namespace

// ptrs: kNumLanes device pointers (null for a lane the cache entry lacks);
// ints, floats: host arrays of kernels/site_account.INTS and FLOATS. The
// counts are checked against this source's structs.
extern "C" int rt_site_account(void* const* ptrs, int n_ptrs, const int* ints,
                               int n_ints, const float* floats, int n_floats,
                               void* stream) {
  if (n_ptrs != kNumLanes || n_ints != kNumInts || n_floats != kNumFloats)
    return cudaErrorInvalidValue;
  Lanes L;
  Ints g;
  Floats f;
  std::memcpy(&L, ptrs, sizeof L);
  std::memcpy(&g, ints, sizeof g);
  std::memcpy(&f, floats, sizeof f);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  site_account_rows<<<dim3(g.chunks, g.m), kThreads, 0, s>>>(L, g);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  site_account_epilogue<<<1, kThreads, 0, s>>>(L, g, f);
  return cudaGetLastError();
}
