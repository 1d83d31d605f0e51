// Fused quantize → delta → tile mask (the delta-value-register analogue).
//
// Replaces: src/repro/kernels/delta_quant.py, `delta_quant` (`_kernel`).
//
//   q     = clip(rint(x / scale), -127, 127)          -> int8
//   delta = (q - prev_q) · scale                       -> delta dtype
//   mask  = any(q != prev_q) over each (block_m × block_k) tile -> int32
//
// Bound on the H100: bytes. It reads x and prev_q and writes q and delta
// once (about 6 bytes per element in bf16, 1 FLOP-ish each), so it is a pure
// stream; at decode (8 × K ≤ 8 × 25600) it is over in a few microseconds and
// its launch is most of its cost.
//
// Design. One CTA per tile, as one grid step on the TPU; the tile's "any
// changed" bit is a CTA-wide `__syncthreads_or`, written once. The codes must
// equal the reference bit for bit, so the division is a true IEEE division
// (`__fdiv_rn`, never a multiply by the reciprocal), the rounding is half to
// even (`rintf`), the delta product is `__fmul_rn` (no contraction), and the
// bf16 cast rounds to nearest even. Build without --use_fast_math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename TX, typename TD>
__global__ void __launch_bounds__(kThreads)
delta_quant_kernel(const TX* __restrict__ x, const int8_t* __restrict__ prev_q,
                   const float* __restrict__ scale, int8_t* __restrict__ q,
                   TD* __restrict__ delta, int* __restrict__ mask, int K,
                   int block_m, int block_k) {
  const int kt = blockIdx.x, mt = blockIdx.y;
  const int gk = gridDim.x;
  const float s = *scale;
  int changed = 0;
  for (int e = threadIdx.x; e < block_m * block_k; e += kThreads) {
    const int r = e / block_k, c = e % block_k;
    const size_t i = (size_t)(mt * block_m + r) * K + (size_t)kt * block_k + c;
    float qf = rintf(__fdiv_rn(load_f32(x + i), s));
    qf = fminf(fmaxf(qf, -127.f), 127.f);
    const int qi = (int)qf;
    const int dq = qi - (int)prev_q[i];
    q[i] = (int8_t)qi;
    store(delta + i, __fmul_rn((float)dq, s));
    changed |= (dq != 0);
  }
  changed = __syncthreads_or(changed);
  if (threadIdx.x == 0) mask[(size_t)mt * gk + kt] = changed ? 1 : 0;
}

template <typename TX, typename TD>
cudaError_t launch(const void* x, const void* prev_q, const void* scale,
                   void* q, void* delta, void* mask, int M, int K, int block_m,
                   int block_k, cudaStream_t stream) {
  dim3 grid(K / block_k, M / block_m);
  delta_quant_kernel<TX, TD><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const int8_t*>(prev_q),
      static_cast<const float*>(scale), static_cast<int8_t*>(q),
      static_cast<TD*>(delta), static_cast<int*>(mask), K, block_m, block_k);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = f32, 1 = bf16.
extern "C" int rt_delta_quant(const void* x, int x_dtype, const void* prev_q,
                              const void* scale, void* q, void* delta,
                              int delta_dtype, void* mask, int M, int K,
                              int block_m, int block_k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1 && delta_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, prev_q, scale, q, delta,
                                                mask, M, K, block_m, block_k, s);
  if (x_dtype == 1)
    return launch<__nv_bfloat16, float>(x, prev_q, scale, q, delta, mask, M, K,
                                        block_m, block_k, s);
  if (delta_dtype == 1)
    return launch<float, __nv_bfloat16>(x, prev_q, scale, q, delta, mask, M, K,
                                        block_m, block_k, s);
  return launch<float, float>(x, prev_q, scale, q, delta, mask, M, K, block_m,
                              block_k, s);
}
