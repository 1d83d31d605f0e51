// A reuse site call's bookkeeping, shared by the two kernels that end with
// it: csrc/site_account.cu (a caller that holds the call's codes: basic
// mode) and csrc/delta_quant.cu's fused instance (reuse mode, which makes
// the codes). Both write per-(row, part) match counts to a scratch
// `partial`, take a ticket, and the launch's last CTA runs `epilogue`:
//
//   matches[m] = Σ_c partial[m, c]; sim_ema, slot_hit_sum and slot_steps per
//   row; steps, the ctrl occupancy and the scalar sensor counters, from
//   reductions of the tile mask
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
// The last CTA. Each CTA, after its writes (codes, counts, mask word),
// fences and draws one ticket from a counter in device memory that is zero
// when the library loads; `atomicInc` wraps it back to zero at the last
// ticket, so no launch resets it and a captured graph replays as often as
// it likes. Launches of one library on one device run in stream order (the
// port issues them on one stream), so no two draw from it at once. The last
// CTA reads the other CTAs' counts and mask words through L2 (`__ldcg`): no
// CTA of the launch has read them before, and L1 is not coherent.
#pragma once

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

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

__device__ unsigned int account_ticket = 0;

// True on the launch's last CTA once every CTA has passed here; every
// thread of each CTA calls it after its last write.
__device__ __forceinline__ bool last_cta() {
  __shared__ unsigned int s_last;
  __threadfence();  // this thread's writes, before the CTA's ticket
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    const unsigned int n = gridDim.x * gridDim.y;
    s_last = atomicInc(&account_ticket, n - 1) == n - 1;
  }
  __syncthreads();
  const bool last = s_last != 0;
  if (last) __threadfence();  // the other CTAs' writes, before our reads
  return last;
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

__device__ __forceinline__ Scalars load_scalars(const Lanes& L,
                                                const Ints& g) {
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

constexpr int kColWords = 256;  // the live-column bitmap: up to 8192 columns
constexpr int kBatch = 4;       // a lane's loads in flight: 128 columns a warp

// Every lane of the call, by the last CTA with all of its threads (any CTA
// shape). Latency, not bytes, bounds it, so every load it needs is issued
// before any is used: thread 0's scalar lanes; a warp a row, whose lane 0
// loads the row's lanes while the lanes load the row's match-count
// partials and its row of the mask, kBatch columns each before any is
// summed (summing each as it arrives waits one L2 round trip a column);
// then warp sums, shared reductions (the live columns as a bitmap), and
// thread 0's stores. The budget is compared only at the
// end (rows over it: the largest row count against it).
__device__ void epilogue(const Lanes& L, const Ints& g, const Floats& f) {
  // mask reductions: Σ mask, Σ over owned columns, nonzero tiles, nonzero
  // tiles at k >= 1, all-zero rows, Σ max(row count, 1), the largest row
  // count, Σ of the column maxima
  enum { kSum, kOwn, kNnz, kNnzK1, kZeroRows, kClampSum, kMaxRow, kLive,
         kRed };
  __shared__ int red[kRed];
  __shared__ unsigned int cols[kColWords];
  const int tid = threadIdx.x + blockDim.x * threadIdx.y;
  const int nthreads = blockDim.x * blockDim.y;
  const int lane = tid & 31, warp = tid >> 5, nwarps = (nthreads + 31) >> 5;
  const int in_warp = nthreads - (warp << 5);  // threads of this warp
  const unsigned wmask = in_warp >= 32 ? 0xffffffffu : (1u << in_warp) - 1u;
  const bool reuse = !g.basic, sensor = g.has_sensor != 0;
  const bool bitmap = g.gk <= kColWords * 32;  // else a column loop
  Scalars v{};
  if (tid == 0) v = load_scalars(L, g);
  for (int i = tid; i < kRed; i += nthreads) red[i] = 0;
  if (reuse && bitmap)
    for (int i = tid; i < kColWords; i += nthreads) cols[i] = 0;
  __syncthreads();
  int sum = 0, own = 0, nnz = 0, nnz_k1 = 0, zero_rows = 0, clamp_sum = 0,
      max_row = 0;
  const int rows = max(g.m, reuse ? g.gm : 0);
  for (int m = warp; m < rows; m += nwarps) {
    const bool prow = m < g.m, mrow = reuse && m < g.gm;
    float sim = 0.f, hit = 0.f;
    int slot = 0;
    if (prow && lane == 0) {
      sim = L.sim_ema[m];
      if (sensor) {
        hit = L.slot_hit_sum[m];
        slot = L.slot_steps[m];
      }
    }
    int count = 0, rs = 0, ro = 0, rn = 0, r1 = 0;
    const int width = max(prow ? g.chunks : 0, mrow ? g.gk : 0);
    for (int c0 = 0; c0 < width; c0 += 32 * kBatch) {
      // a batch's loads, all issued before the first is used
      int pv[kBatch], mv[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int c = c0 + lane + 32 * j;
        pv[j] = prow && c < g.chunks
                    ? __ldcg(L.partial + (size_t)m * g.chunks + c) : 0;
        mv[j] = mrow && c < g.gk ? __ldcg(L.mask + (size_t)m * g.gk + c) : 0;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int c = c0 + lane + 32 * j, x = mv[j];
        count += pv[j];
        if (x != 0) {  // 0 past the row's end
          rs += x;
          if (g.shard_count == 0 || c % g.shard_count == g.shard_index)
            ro += x;
          rn += 1;
          r1 += c >= 1;
          if (bitmap) atomicOr(&cols[c >> 5], 1u << (c & 31));
        }
      }
    }
    if (prow) {
      count = __reduce_add_sync(wmask, count);
      if (lane == 0) {
        const float mt = (float)count;  // exact: count <= K < 2^24
        L.matches[m] = mt;
        L.sim_ema[m] = __fmaf_rn(sim, f.decay, __fmul_rn(mt, f.c_sim));
        if (sensor) {
          L.slot_hit_sum[m] = __fmaf_rn(mt, f.inv_k, hit);
          L.slot_steps[m] = slot + 1;
        }
      }
    }
    if (mrow) {
      rn = __reduce_add_sync(wmask, rn);
      sum += __reduce_add_sync(wmask, rs);
      own += __reduce_add_sync(wmask, ro);
      nnz += rn;
      nnz_k1 += __reduce_add_sync(wmask, r1);
      zero_rows += rn == 0;
      clamp_sum += max(rn, 1);
      max_row = max(max_row, rn);
    }
  }
  if (reuse) {
    if (lane == 0) {  // each warp's row sums, once
      atomicAdd(&red[kSum], sum);
      atomicAdd(&red[kOwn], own);
      atomicAdd(&red[kNnz], nnz);
      atomicAdd(&red[kNnzK1], nnz_k1);
      atomicAdd(&red[kZeroRows], zero_rows);
      atomicAdd(&red[kClampSum], clamp_sum);
      atomicMax(&red[kMaxRow], max_row);
    }
    if (!bitmap) {  // the column maxima, a column a thread
      int live = 0;
      for (int c = tid; c < g.gk; c += nthreads) {
        int mx = INT_MIN;
        for (int r = 0; r < g.gm; ++r)
          mx = max(mx, __ldcg(L.mask + (size_t)r * g.gk + c));
        live += mx;
      }
      atomicAdd(&red[kLive], live);
    }
  }
  __syncthreads();
  if (reuse && bitmap) {  // the mask holds 0 or 1: Σ max = live columns
    int live = 0;
    for (int i = tid; i < (g.gk + 31) / 32; i += nthreads)
      live += __popc(cols[i]);
    if (live) atomicAdd(&red[kLive], live);
    __syncthreads();
  }
  if (tid != 0) return;
  const int kb = v.budget;
  *L.steps = v.steps + 1;
  if (reuse && g.has_ctrl)
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
      const int over =
          g.path == kRagged ? red[kMaxRow] > kb : red[kLive] > kb;
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
