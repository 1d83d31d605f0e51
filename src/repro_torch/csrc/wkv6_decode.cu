// Fused RWKV6 decode step, one pass over the [dk, dv] f32 state per head:
//
//   kv[i,j]  = k[i] · v[j]
//   out[j]   = Σ_i r[i] · (u[i] · kv[i,j] + S[i,j])
//   S'[i,j]  = w[i] · S[i,j] + kv[i,j]
//
// S' goes to `state_out`, which may be `state` itself: the serve passes the
// same pointer and updates its decode state in place; the training sequence
// (`WKV6Sequence`) steps from states[t] into states[t+1] of one buffer.
//
// Replaces: src/repro/kernels/wkv6_decode.py, `wkv6_decode` (`_kernel`).
//
// Bound on the H100: bytes. Each (batch, head) reads and writes its 16 KB
// state once and does about 6 FLOP per state element, far below the card's
// ~20 FLOP/byte f32 ridge. At rwkv6-7b decode (B = 8, H = 64) that is 16.8 MB
// of state traffic, 5 µs at 3.35 TB/s; the launch costs about as much.
//
// Design. On the TPU one grid step per (b·h) holds the state tile in VMEM.
// Here one CTA per (b·h) streams its state rows once: thread t owns four
// columns (one 16-byte load) of the rows i ≡ t / (dv/4) mod groups, so a row
// is read by dv/4 neighbouring threads as one contiguous burst and `groups`
// rows are in flight at a time. r, k, w and u are staged in shared memory.
// Each element is read, updated and written back by the same thread, so the
// in-place update (state_out == state) has no hazard; the two state pointers
// carry no __restrict__, since they may alias. The update uses __fmul_rn/__fadd_rn, which
// nvcc never contracts into an FMA: S' is bitwise equal to the plain PyTorch
// version, which computes `w·S` and `+ kv` as two kernels. The readout's
// partial sums per row group are reduced in shared memory in a fixed order.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDk = 1024;

__global__ void __launch_bounds__(kThreads)
wkv6_decode_kernel(const float* __restrict__ r, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ w,
                   const float* __restrict__ u, const float* state,
                   float* state_out, float* __restrict__ out, int H, int dk,
                   int dv) {
  __shared__ float r_s[kMaxDk], k_s[kMaxDk], w_s[kMaxDk], u_s[kMaxDk];
  __shared__ float red[kThreads * 4];
  const int bh = blockIdx.x;
  const int h = bh % H;
  for (int i = threadIdx.x; i < dk; i += kThreads) {
    r_s[i] = r[(size_t)bh * dk + i];
    k_s[i] = k[(size_t)bh * dk + i];
    w_s[i] = w[(size_t)bh * dk + i];
    u_s[i] = u[(size_t)h * dk + i];
  }
  __syncthreads();
  const int tpr = dv / 4;             // threads per state row
  const int groups = kThreads / tpr;  // rows in flight
  const int col = (threadIdx.x % tpr) * 4;
  const int group = threadIdx.x / tpr;
  const float4 vv = *reinterpret_cast<const float4*>(v + (size_t)bh * dv + col);
  const float vj[4] = {vv.x, vv.y, vv.z, vv.w};
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const float* s = state + (size_t)bh * dk * dv;
  float* so = state_out + (size_t)bh * dk * dv;
  for (int i = group; i < dk; i += groups) {
    const float4 sv =
        *reinterpret_cast<const float4*>(s + (size_t)i * dv + col);
    const float si[4] = {sv.x, sv.y, sv.z, sv.w};
    float sn[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float kv = __fmul_rn(k_s[i], vj[j]);
      acc[j] = fmaf(r_s[i], __fadd_rn(__fmul_rn(u_s[i], kv), si[j]), acc[j]);
      sn[j] = __fadd_rn(__fmul_rn(w_s[i], si[j]), kv);
    }
    *reinterpret_cast<float4*>(so + (size_t)i * dv + col) =
        make_float4(sn[0], sn[1], sn[2], sn[3]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) red[group * dv + col + j] = acc[j];
  __syncthreads();
  for (int j = threadIdx.x; j < dv; j += kThreads) {
    float o = 0.f;
    for (int g = 0; g < groups; ++g) o += red[g * dv + j];
    out[(size_t)bh * dv + j] = o;
  }
}

}  // namespace

// r, k, w: [B·H, dk]; v: [B·H, dv]; u: [H, dk]; state, state_out: [B·H, dk,
// dv] (the same pointer for an update in place, else not overlapping); out:
// [B·H, dv]. All f32, contiguous; dv / 4 divides 256 and dk <= 1024
// (checked by the wrapper).
extern "C" int rt_wkv6_decode(const void* r, const void* k, const void* v,
                              const void* w, const void* u, const void* state,
                              void* state_out, void* out, int BH, int H,
                              int dk, int dv, void* stream) {
  wkv6_decode_kernel<<<BH, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(state),
      static_cast<float*>(state_out), static_cast<float*>(out), H, dk, dv);
  return cudaGetLastError();
}
