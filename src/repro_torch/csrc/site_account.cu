// A site call's cache bookkeeping for a caller that holds the call's
// codes, in one launch: the basic-mode call (and any caller without a
// delta_quant pass; the reuse-mode call fuses this work into delta_quant's
// launch, csrc/delta_quant.cu):
//
//   rows:     partial[m, c] = #{k in chunk c : cur_q[m, k] == prev_q[m, k]},
//             then prev_q[m, k] = cur_q[m, k] (each element read, then written,
//             by the same thread)
//   last CTA: every other lane (csrc/site_account.cuh `epilogue`)
//
// Replaces: no TPU kernel. The reference computes these lanes in the jitted
// step around its kernels (src/repro/core/reuse_linear.py:222-264 and
// src/repro/sensor/counters.py:151-281), where XLA fuses them; run eagerly
// they were about a hundred small kernels a site call.
//
// Bound on the H100: bytes, and at decode sizes the launch. The row pass
// reads cur_q and prev_q and writes prev_q, 3·M·K bytes (0.61 MB at
// [8, 25600], 0.18 µs at 3.35 TB/s); the epilogue reads the [gm, gk] mask
// and a few hundred bytes of lanes. Both are far below the ~2 µs a launch
// costs, so the design is one launch: a CTA per (row, 4 KB chunk) with
// 16-byte compares where the operands allow, and the last CTA to finish
// (a ticket, csrc/site_account.cuh) runs the epilogue. The budget is read
// from its device lane, so a captured graph reads the live value; nothing
// is allocated here (the wrapper's scratch).
#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

#include "site_account.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;

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
site_account_kernel(Lanes L, Ints g, Floats f) {
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
  if (last_cta()) epilogue(L, g, f);
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
  site_account_kernel<<<dim3(g.chunks, g.m), kThreads, 0, s>>>(L, g, f);
  return cudaGetLastError();
}
