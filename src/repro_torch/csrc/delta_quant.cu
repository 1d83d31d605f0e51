// Fused quantize → delta → tile mask (the delta-value-register analogue).
//
// Replaces: src/repro/kernels/delta_quant.py, `delta_quant` (`_kernel`).
//
//   q     = clip(rint(x / scale), -127, 127)          -> int8
//   delta = (q - prev_q) · scale                       -> delta dtype
//   mask  = any(q != prev_q) over each (block_m × block_k) tile -> int32
//
// Bound on the H100: bytes. It reads x and prev_q and writes q and delta
// once (6 bytes per element in bf16, a few operations each), so it is a pure
// stream. At decode (8 × K, K ≤ 25600) the byte bound is a fraction of a
// microsecond, below what one launch costs: the floor that counts is the
// launch plus one memory round trip.
//
// Design: one memory round trip per thread. One CTA per tile (the TPU's grid
// step), with threads laid out (tx, ty) over (vectors of a row, rows): a
// thread owns VEC consecutive elements of a row, so its row and column come
// from blockIdx/threadIdx alone, with no integer division. In the vector
// instance (VEC = 8) that is one 16-byte load of bf16 x (two of f32), one
// 8-byte load of prev_q, one 8-byte store of q and one 16-byte store of bf16
// delta (two of f32). Every load of a chunk of rows is issued before any
// arithmetic, and the first chunk's loads go out before the barrier that
// hands every thread `scale` (read once per CTA), so at the serve's tiles
// (8 × 256, one row per thread) the whole tile is one pass with one wait.
// A tile taller than one pass (block_m 128) is cut into row slices over a
// cluster of up to 8 CTAs on as many SMs, two rows in flight per thread
// (a 128 × 256 tile: 16 rows a CTA, one chunk);
// rank 0 ORs the slices' bits through distributed shared memory. The tile's
// "any changed" bit is a CTA-wide `__syncthreads_or`, written by one thread,
// once: no atomics, so no zeroing launch. The scalar instance (VEC = 1) is
// the same kernel for operands the vector access cannot take (a pointer not
// 16-byte aligned, block_k % 8 != 0).
//
// The codes must equal the reference bit for bit, so the division is a true
// IEEE division (`__fdiv_rn`, never a multiply by the reciprocal), the
// rounding is half to even (`rintf`), the delta product is `__fmul_rn` (no
// contraction), and the bf16 cast rounds to nearest even. Build without
// --use_fast_math.
//
// The fused instance (`rt_delta_quant_account`, `delta_quant_account_kernel`)
// is a reuse site call's whole pass before its ΔW GEMM: the same tile work
// on the call's own operands, plus the call's bookkeeping, which needs the
// codes this pass already holds in registers (csrc/site_account.cu would
// read them back). It reads x and the cache entry's prev_q
// unpadded (a row or column past M or K reads as 0 on both sides, as the
// padding entry's zeros do, so the mask bits are the same), writes the codes
// back into prev_q (each element read, then written, by the same thread: no
// __restrict__ and no __ldg on prev_q there) and delta into a buffer padded
// to whole tiles, counts each real row's unchanged codes per tile into a
// scratch `partial[M, gk]` (a warp-level sum, one shared add a row and
// warp), and the launch's last CTA runs the epilogue of
// csrc/site_account.cuh (sim_ema, steps, the occupancy and every sensor
// lane). One launch where there were two, and no q tensor: its bound is
// this kernel's bytes less the q write.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <type_traits>

#include "site_account.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // most threads of a CTA

// ---- loads of VEC consecutive elements, widened to f32 / int
template <int VEC>
__device__ __forceinline__ void load_x(const __nv_bfloat16* p, float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}

template <int VEC>
__device__ __forceinline__ void load_x(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    v[0] = __ldg(p);
  }
}

// NC: through the read-only path (__ldg); else a plain load, for codes the
// kernel writes back in place
template <int VEC, bool NC>
__device__ __forceinline__ void load_q(const int8_t* p, int (&v)[VEC]) {
  if constexpr (VEC == 8) {
    const uint2 u = NC ? __ldg(reinterpret_cast<const uint2*>(p))
                       : *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = (int)(int8_t)(u.x >> (8 * i));
      v[4 + i] = (int)(int8_t)(u.y >> (8 * i));
    }
  } else {
    v[0] = NC ? (int)__ldg(p) : (int)*p;
  }
}

// ---- stores of VEC consecutive results (through the store intrinsics, so a
// packed 16-byte value leaves as one STG.E.128, not four 4-byte stores)
template <int VEC>
__device__ __forceinline__ void store_q(int8_t* p, const int (&v)[VEC]) {
  if constexpr (VEC == 8) {
    uint2 u = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      u.x |= (uint32_t)(v[i] & 0xff) << (8 * i);
      u.y |= (uint32_t)(v[4 + i] & 0xff) << (8 * i);
    }
    __stwb(reinterpret_cast<uint2*>(p), u);
  } else {
    p[0] = (int8_t)v[0];
  }
}

__device__ __forceinline__ uint32_t bf16_bits(float f) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f));
}

template <int VEC>
__device__ __forceinline__ void store_d(__nv_bfloat16* p, const float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = bf16_bits(v[2 * i]) | (bf16_bits(v[2 * i + 1]) << 16);
    __stwb(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
  } else {
    p[0] = __float2bfloat16_rn(v[0]);
  }
}

template <int VEC>
__device__ __forceinline__ void store_d(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    __stwb(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
    __stwb(reinterpret_cast<float4*>(p) + 1,
           make_float4(v[4], v[5], v[6], v[7]));
  } else {
    p[0] = v[0];
  }
}

constexpr int kMaxRows = 256;  // rows of a CTA the fused instance counts

// Adds each thread's `v` into s_count[row] for the threads whose row is
// real (`row` >= 0). A row's threads are the blockDim.x consecutive threads
// of one threadIdx.y: with blockDim.x a power of two they are an aligned
// run of lanes (or whole warps), summed by shuffles and added once a run;
// else every thread adds its own.
__device__ __forceinline__ void count_row(int v, int row, int* s_count) {
  const int tx = blockDim.x;
  if ((tx & (tx - 1)) == 0) {
    const int tid = threadIdx.x + tx * threadIdx.y;
    const int in_warp = tx * blockDim.y - (tid & ~31);
    const unsigned wmask = in_warp >= 32 ? 0xffffffffu : (1u << in_warp) - 1u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      if (o < tx) v += __shfl_xor_sync(wmask, v, o);
    if (row >= 0 && (threadIdx.x & (min(tx, 32) - 1)) == 0)
      atomicAdd(&s_count[row], v);
  } else if (row >= 0 && v != 0) {
    atomicAdd(&s_count[row], v);
  }
}

// One CTA per (block_m × block_k) tile, or per row slice of it: a tile of
// more rows than one pass of the CTA covers is cut across a cluster of
// 2^shift CTAs along y (at most 8), each owning block_m >> shift rows, so a
// 128-row tile is not one SM's serial work. blockDim = (tx, ty), tx threads
// over a row's block_k / VEC vectors and ty over its rows. A CTA walks its
// rows in chunks of (tx vectors) × (ITEMS · ty rows), from bases that
// advance by addition (no integer division); at the serve's tiles there is
// one chunk and no cluster.
//
// ACCOUNT (the fused instance): x and prev_q are [M, K] with row stride K,
// positions past M or K read as 0; the codes go back into prev_q (q is
// unused), delta has row stride ldd (whole tiles), and each real row's
// unchanged codes in real columns go to partial[row, tile]. Otherwise all
// operands are whole tiles of row stride K, as the padding entry makes them.
template <typename TX, typename TD, int VEC, int ITEMS, bool ACCOUNT>
__device__ __forceinline__ void dq_tile(
    const TX* __restrict__ x,
    std::conditional_t<ACCOUNT, int8_t*, const int8_t*> prev_q,
    const float* __restrict__ scale, int8_t* __restrict__ q,
    TD* __restrict__ delta, int* mask, int K, int block_m, int block_k,
    int shift, int M, int ldd, int* partial) {
  __shared__ float s_scale;
  __shared__ int s_changed;
  __shared__ int s_count[ACCOUNT ? kMaxRows : 1];
  const int vpr = block_k / VEC;               // vectors in a tile row
  const int chunk = ITEMS * blockDim.y;        // rows in a chunk
  const int rows = block_m >> shift;           // rows of this CTA
  const int rank = blockIdx.y & ((1 << shift) - 1);
  const int tm = blockIdx.y >> shift;          // tile row
  const int row0 = tm * block_m + rank * rows;  // this CTA's first row
  const int col0 = blockIdx.x * block_k;
  const size_t base = (size_t)row0 * K + (size_t)col0;
  const size_t dbase = ACCOUNT ? (size_t)row0 * ldd + col0 : base;
  const int ldo = ACCOUNT ? ldd : K;           // delta's row stride
  const int tid = threadIdx.x + blockDim.x * threadIdx.y;

  float xv[ITEMS][VEC];
  int pv[ITEMS][VEC];
  // whether (row r of this CTA, vector column cv) holds real elements:
  // always, past the fused instance's edges never
  auto real = [&](int r, int cv) {
    return !ACCOUNT || (row0 + r < M && col0 + cv * VEC < K);
  };
  // the chunk at (column base cb, row base rb): this thread's vector column
  // cb + threadIdx.x and rows rb + threadIdx.y + i·blockDim.y, i < ITEMS
  auto load = [&](int cb, int rb) {
    const int cv = cb + threadIdx.x;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int r = rb + threadIdx.y + i * blockDim.y;
      if (cv < vpr && r < rows) {
        const size_t off = base + (size_t)r * K + (size_t)cv * VEC;
        if (real(r, cv)) {
          load_x<VEC>(x + off, xv[i]);
          load_q<VEC, !ACCOUNT>(prev_q + off, pv[i]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            xv[i][e] = 0.f;
            pv[i][e] = 0;
          }
        }
      }
    }
  };

  // the first chunk's loads are in flight while thread 0 fetches the scale
  const bool lead = threadIdx.x == 0 && threadIdx.y == 0;
  if constexpr (ACCOUNT)
    for (int t = tid; t < rows; t += blockDim.x * blockDim.y) s_count[t] = 0;
  load(0, 0);
  if (lead) s_scale = __ldg(scale);
  __syncthreads();
  const float s = s_scale;

  int changed = 0;
  for (int cb = 0; cb < vpr; cb += blockDim.x) {
    for (int rb = 0; rb < rows; rb += chunk) {
      if (cb | rb) load(cb, rb);
      const int cv = cb + threadIdx.x;
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const int r = rb + threadIdx.y + i * blockDim.y;
        int same = 0;  // unchanged codes of this item
        if (cv < vpr && r < rows) {
          int qi[VEC];
          float dv[VEC];
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            float qf = rintf(__fdiv_rn(xv[i][e], s));
            qf = fminf(fmaxf(qf, -127.f), 127.f);
            qi[e] = (int)qf;
            const int dq = qi[e] - pv[i][e];
            dv[e] = __fmul_rn((float)dq, s);
            changed |= (dq != 0);
            same += dq == 0;
          }
          const size_t off = base + (size_t)r * K + (size_t)cv * VEC;
          const size_t doff = dbase + (size_t)r * ldo + (size_t)cv * VEC;
          if constexpr (ACCOUNT) {
            if (real(r, cv)) store_q<VEC>(prev_q + off, qi);
            else same = 0;
          } else {
            store_q<VEC>(q + off, qi);
          }
          store_d<VEC>(delta + doff, dv);
        }
        if constexpr (ACCOUNT)
          count_row(same, r < rows && row0 + r < M ? r : -1, s_count);
      }
    }
  }
  changed = __syncthreads_or(changed);
  if constexpr (ACCOUNT) {
    for (int t = tid; t < rows && row0 + t < M; t += blockDim.x * blockDim.y)
      partial[(size_t)(row0 + t) * gridDim.x + blockIdx.x] = s_count[t];
  }
  int* word = mask + (size_t)tm * gridDim.x + blockIdx.x;
  if (shift == 0) {
    if (lead) *word = changed ? 1 : 0;
    return;
  }
  // rank 0 ORs the slices' bits out of their shared memory: one writer
  cg::cluster_group cl = cg::this_cluster();
  if (lead) s_changed = changed;
  cl.sync();
  if (rank == 0 && lead) {
    int any = 0;
    for (int r = 0; r < (1 << shift); ++r)
      any |= *cl.map_shared_rank(&s_changed, r);
    *word = any ? 1 : 0;
  }
  cl.sync();  // no CTA leaves while rank 0 still reads its bit
}

template <typename TX, typename TD, int VEC, int ITEMS>
__global__ void __launch_bounds__(kThreads)
delta_quant_kernel(const TX* __restrict__ x, const int8_t* prev_q,
                   const float* __restrict__ scale, int8_t* __restrict__ q,
                   TD* __restrict__ delta, int* __restrict__ mask, int K,
                   int block_m, int block_k, int shift) {
  dq_tile<TX, TD, VEC, ITEMS, false>(x, prev_q, scale, q, delta, mask, K,
                                     block_m, block_k, shift, 0, K, nullptr);
}

// The fused instance: the tile work, then the call's bookkeeping on the
// last CTA (after the cluster's OR: each CTA draws its ticket past its
// last cl.sync, so the mask word is written by then).
template <typename TX, typename TD, int VEC, int ITEMS>
__global__ void __launch_bounds__(kThreads)
delta_quant_account_kernel(const TX* __restrict__ x,
                           const float* __restrict__ scale,
                           TD* __restrict__ delta, int M, int K, int ldd,
                           int block_m, int block_k, int shift, Lanes L,
                           Ints g, Floats f) {
  dq_tile<TX, TD, VEC, ITEMS, true>(x, L.prev_q, scale, nullptr, delta,
                                    const_cast<int*>(L.mask), K, block_m,
                                    block_k, shift, M, ldd, L.partial);
  if (last_cta()) epilogue(L, g, f);
}

// the fused instance's arguments beyond the tile's (null: the TPU kernel's
// port, rt_delta_quant)
struct Account {
  int M, ldd;
  Lanes L;
  Ints g;
  Floats f;
};

template <int ITEMS, typename TX, typename TD, int VEC>
cudaError_t launch_items(const cudaLaunchConfig_t& cfg, const void* x,
                         const void* prev_q, const void* scale, void* q,
                         void* delta, void* mask, int K, int block_m,
                         int block_k, int shift, const Account* acc) {
  if (acc != nullptr)
    return cudaLaunchKernelEx(
        &cfg, delta_quant_account_kernel<TX, TD, VEC, ITEMS>,
        static_cast<const TX*>(x), static_cast<const float*>(scale),
        static_cast<TD*>(delta), acc->M, K, acc->ldd, block_m, block_k, shift,
        acc->L, acc->g, acc->f);
  return cudaLaunchKernelEx(
      &cfg, delta_quant_kernel<TX, TD, VEC, ITEMS>, static_cast<const TX*>(x),
      static_cast<const int8_t*>(prev_q), static_cast<const float*>(scale),
      static_cast<int8_t*>(q), static_cast<TD*>(delta),
      static_cast<int*>(mask), K, block_m, block_k, shift);
}

// The CTA shape, the cluster's row slices and the rows in flight per thread,
// from the tile shape; the grid covers ceil(M / block_m) × ceil(K / block_k)
// tiles (whole tiles but in the fused instance).
template <typename TX, typename TD, int VEC>
cudaError_t launch_vec(const void* x, const void* prev_q, const void* scale,
                       void* q, void* delta, void* mask, int M, int K,
                       int block_m, int block_k, const Account* acc,
                       cudaStream_t stream) {
  const int vpr = block_k / VEC;
  const int tx = vpr < kThreads ? vpr : kThreads;
  const int ty = kThreads / tx < block_m ? kThreads / tx : block_m;
  int shift = 0;  // slices = 2^shift <= 8, dividing block_m, of >= ty rows
  while (shift < 3 && (block_m >> (shift + 1)) >= ty &&
         block_m % (2 << shift) == 0)
    ++shift;
  const int per_thread = ((block_m >> shift) + ty - 1) / ty;
  if (acc != nullptr && (block_m >> shift) > kMaxRows)
    return cudaErrorInvalidValue;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((K + block_k - 1) / block_k,
                     ((M + block_m - 1) / block_m) << shift, 1);
  cfg.blockDim = dim3(tx, ty, 1);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1 << shift;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = shift > 0 ? 1 : 0;
  // one row per thread at the serve's tiles; else two rows in flight per
  // chunk (a 128-row tile's slice of 16 rows is one chunk)
  const cudaError_t e =
      per_thread == 1
          ? launch_items<1, TX, TD, VEC>(cfg, x, prev_q, scale, q, delta, mask,
                                         K, block_m, block_k, shift, acc)
          : launch_items<2, TX, TD, VEC>(cfg, x, prev_q, scale, q, delta, mask,
                                         K, block_m, block_k, shift, acc);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename TX, typename TD>
cudaError_t launch(const void* x, const void* prev_q, const void* scale,
                   void* q, void* delta, void* mask, int M, int K, int block_m,
                   int block_k, int vec, const Account* acc,
                   cudaStream_t stream) {
  if (vec)
    return launch_vec<TX, TD, 8>(x, prev_q, scale, q, delta, mask, M, K,
                                 block_m, block_k, acc, stream);
  return launch_vec<TX, TD, 1>(x, prev_q, scale, q, delta, mask, M, K,
                               block_m, block_k, acc, stream);
}

cudaError_t dispatch(const void* x, int x_dtype, const void* prev_q,
                     const void* scale, void* q, void* delta, int delta_dtype,
                     void* mask, int M, int K, int block_m, int block_k,
                     int vec, const Account* acc, cudaStream_t s) {
  if (x_dtype == 1 && delta_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        x, prev_q, scale, q, delta, mask, M, K, block_m, block_k, vec, acc, s);
  if (x_dtype == 1)
    return launch<__nv_bfloat16, float>(x, prev_q, scale, q, delta, mask, M, K,
                                        block_m, block_k, vec, acc, s);
  if (delta_dtype == 1)
    return launch<float, __nv_bfloat16>(x, prev_q, scale, q, delta, mask, M, K,
                                        block_m, block_k, vec, acc, s);
  return launch<float, float>(x, prev_q, scale, q, delta, mask, M, K, block_m,
                              block_k, vec, acc, s);
}

}  // namespace

// dtype codes: 0 = f32, 1 = bf16. vec = 1 takes the 8-wide vector instance:
// the caller vouches that x, prev_q, q and delta are 16-byte aligned and
// block_k % 8 == 0; vec = 0 takes the scalar instance, which needs neither.
extern "C" int rt_delta_quant(const void* x, int x_dtype, const void* prev_q,
                              const void* scale, void* q, void* delta,
                              int delta_dtype, void* mask, int M, int K,
                              int block_m, int block_k, int vec,
                              void* stream) {
  return dispatch(x, x_dtype, prev_q, scale, q, delta, delta_dtype, mask, M,
                  K, block_m, block_k, vec, nullptr,
                  static_cast<cudaStream_t>(stream));
}

// The fused instance. x [M, K] and the lanes' prev_q [M, K] unpadded; delta
// [ceil(M/bm)·bm, ceil(K/bk)·bk]; ptrs, ints, floats as rt_site_account's
// (kernels/site_account's lanes, INTS and FLOATS: prev_q, partial [M, gk],
// matches and the mask [gm, gk] among the lanes). vec = 1: x, prev_q and
// delta 16-byte aligned, K and block_k multiples of 8.
extern "C" int rt_delta_quant_account(const void* x, int x_dtype,
                                      const void* scale, void* delta,
                                      int delta_dtype, int M, int K,
                                      int block_m, int block_k, int vec,
                                      void* const* ptrs, int n_ptrs,
                                      const int* ints, int n_ints,
                                      const float* floats, int n_floats,
                                      void* stream) {
  if (n_ptrs != kNumLanes || n_ints != kNumInts || n_floats != kNumFloats)
    return cudaErrorInvalidValue;
  Account acc;
  std::memcpy(&acc.L, ptrs, sizeof acc.L);
  std::memcpy(&acc.g, ints, sizeof acc.g);
  std::memcpy(&acc.f, floats, sizeof acc.f);
  acc.M = M;
  acc.ldd = (K + block_k - 1) / block_k * block_k;
  return dispatch(x, x_dtype, acc.L.prev_q, scale, nullptr, delta,
                  delta_dtype, const_cast<int*>(acc.L.mask), M, K, block_m,
                  block_k, vec, &acc, static_cast<cudaStream_t>(stream));
}
