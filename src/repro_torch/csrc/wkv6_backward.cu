// The gradient of one RWKV6 recurrence step (the step of wkv6_decode.cu),
// per (batch, head), with kv = k ⊗ v, ḡo = ∂L/∂out [dv] and Ḡ = ∂L/∂S' [dk, dv]:
//
//   r̄[i]     = Σ_j ḡo[j] · (u[i] · k[i] · v[j] + S[i,j])
//   ū[i]     = r[i] · k[i] · Σ_j ḡo[j] · v[j]     (this (b, h)'s partial)
//   k̄v[i,j]  = r[i] · u[i] · ḡo[j] + Ḡ[i,j]
//   k̄[i]     = Σ_j k̄v[i,j] · v[j]
//   v̄[j]     = Σ_i k̄v[i,j] · k[i]
//   w̄[i]     = Σ_j Ḡ[i,j] · S[i,j]
//   S̄[i,j]   = r[i] · ḡo[j] + w[i] · Ḡ[i,j]        (written IN PLACE over Ḡ)
//
// Replaces: no TPU kernel. The reference has no gradient of
// src/repro/kernels/wkv6_decode.py: its training forward is a `lax.scan` of
// jnp ops, which XLA differentiates. The port's rwkv6 training forward steps
// wkv6_decode once per token (`WKV6Sequence` in kernels/wkv6_decode.py), so
// its backward steps this kernel once per token, t = S-1 ... 0, carrying S̄.
//
// Bound on the H100: bytes. Each (batch, head) reads S and Ḡ and writes S̄
// once, 12 bytes per state element, and does about 16 FLOP per element, below
// the card's ~20 FLOP/byte f32 ridge. At rwkv6-7b (B = 8, H = 64, 64 x 64
// states) that is 25.2 MB a step, 7.5 µs at 3.35 TB/s.
//
// Design: the forward's. One CTA per (b·h); thread t owns four columns (one
// 16-byte load of S and one of Ḡ) of the rows i ≡ t / (dv/4) mod groups, so
// a row is one contiguous burst of dv/4 neighbouring threads. r, k, w and u
// are staged in shared memory. The row sums (r̄, k̄, w̄) are reduced across a
// row's dv/4 lanes by warp shuffles (dv <= 128 keeps a row inside a warp) and
// written by the row's first lane; the column sums (v̄) are kept in registers
// over a thread's rows and reduced over the row groups in shared memory in a
// fixed order; ū's dot product Σ ḡo·v is one warp-shuffle sum. Nothing is
// summed with atomics, so a call is bitwise the same from run to run, and ū's
// per-batch partials are summed by the caller in a fixed order. S̄ uses
// __fmul_rn/__fadd_rn, which nvcc never contracts into an FMA: it is bitwise
// the plain PyTorch version, which computes the two products and the sum as
// three kernels. Each S̄ element is written by the thread that read its Ḡ.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDk = 1024;

// sum of v over the `width` lanes of an aligned group inside a warp
__device__ __forceinline__ float group_sum(float v, int width) {
  for (int off = width / 2; off > 0; off /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
wkv6_backward_kernel(const float* __restrict__ r, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ u,
                     const float* __restrict__ state,
                     const float* __restrict__ gout,
                     float* __restrict__ gstate, float* __restrict__ gr,
                     float* __restrict__ gk, float* __restrict__ gv,
                     float* __restrict__ gw, float* __restrict__ gu, int H,
                     int dk, int dv) {
  __shared__ float r_s[kMaxDk], k_s[kMaxDk], w_s[kMaxDk], u_s[kMaxDk];
  __shared__ float red[kThreads * 4];
  __shared__ float gov_s;
  const int bh = blockIdx.x;
  const int h = bh % H;
  for (int i = threadIdx.x; i < dk; i += kThreads) {
    r_s[i] = r[(size_t)bh * dk + i];
    k_s[i] = k[(size_t)bh * dk + i];
    w_s[i] = w[(size_t)bh * dk + i];
    u_s[i] = u[(size_t)h * dk + i];
  }
  const int tpr = dv / 4;             // threads per state row (<= 32)
  const int groups = kThreads / tpr;  // rows in flight
  const int lane = threadIdx.x % tpr;
  const int col = lane * 4;
  const int group = threadIdx.x / tpr;
  const float4 vv = *reinterpret_cast<const float4*>(v + (size_t)bh * dv + col);
  const float4 gg =
      *reinterpret_cast<const float4*>(gout + (size_t)bh * dv + col);
  const float vj[4] = {vv.x, vv.y, vv.z, vv.w};
  const float go[4] = {gg.x, gg.y, gg.z, gg.w};
  {
    float p = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) p = fmaf(go[j], vj[j], p);
    p = group_sum(p, tpr);
    if (threadIdx.x == 0) gov_s = p;
  }
  __syncthreads();

  float vacc[4] = {0.f, 0.f, 0.f, 0.f};
  const float* s = state + (size_t)bh * dk * dv;
  float* g = gstate + (size_t)bh * dk * dv;
  // every lane of a warp runs the same trip count, so the shuffles of a
  // partial last round see all 32 lanes
  for (int i0 = 0; i0 < dk; i0 += groups) {
    const int i = i0 + group;
    const bool live = i < dk;
    float rb = 0.f, kb = 0.f, wb = 0.f;
    if (live) {
      const float ri = r_s[i], ki = k_s[i], wi = w_s[i], ui = u_s[i];
      const float rui = ri * ui;
      const float4 sv =
          *reinterpret_cast<const float4*>(s + (size_t)i * dv + col);
      float4* gp = reinterpret_cast<float4*>(g + (size_t)i * dv + col);
      const float4 gv4 = *gp;
      const float si[4] = {sv.x, sv.y, sv.z, sv.w};
      const float gi[4] = {gv4.x, gv4.y, gv4.z, gv4.w};
      float sn[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kv = ki * vj[j];
        rb = fmaf(go[j], fmaf(ui, kv, si[j]), rb);
        const float kvb = fmaf(rui, go[j], gi[j]);
        kb = fmaf(kvb, vj[j], kb);
        vacc[j] = fmaf(kvb, ki, vacc[j]);
        wb = fmaf(gi[j], si[j], wb);
        sn[j] = __fadd_rn(__fmul_rn(ri, go[j]), __fmul_rn(wi, gi[j]));
      }
      *gp = make_float4(sn[0], sn[1], sn[2], sn[3]);
    }
    rb = group_sum(rb, tpr);
    kb = group_sum(kb, tpr);
    wb = group_sum(wb, tpr);
    if (live && lane == 0) {
      gr[(size_t)bh * dk + i] = rb;
      gk[(size_t)bh * dk + i] = kb;
      gw[(size_t)bh * dk + i] = wb;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) red[group * dv + col + j] = vacc[j];
  __syncthreads();
  for (int j = threadIdx.x; j < dv; j += kThreads) {
    float o = 0.f;
    for (int q = 0; q < groups; ++q) o += red[q * dv + j];
    gv[(size_t)bh * dv + j] = o;
  }
  const float gov = gov_s;
  for (int i = threadIdx.x; i < dk; i += kThreads)
    gu[(size_t)bh * dk + i] = r_s[i] * k_s[i] * gov;
}

}  // namespace

// r, k, w: [B·H, dk]; v, gout: [B·H, dv]; u: [H, dk]; state (S, the step's
// input state) and gstate (Ḡ in, S̄ out): [B·H, dk, dv]; gr, gk, gw, gu:
// [B·H, dk]; gv: [B·H, dv]. All f32, contiguous, 16-byte aligned; dv / 4
// divides 32 and dk <= 1024 (checked by the wrapper).
extern "C" int rt_wkv6_decode_backward(
    const void* r, const void* k, const void* v, const void* w, const void* u,
    const void* state, const void* gout, void* gstate, void* gr, void* gk,
    void* gv, void* gw, void* gu, int BH, int H, int dk, int dv,
    void* stream) {
  wkv6_backward_kernel<<<BH, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(state),
      static_cast<const float*>(gout), static_cast<float*>(gstate),
      static_cast<float*>(gr), static_cast<float*>(gk),
      static_cast<float*>(gv), static_cast<float*>(gw),
      static_cast<float*>(gu), H, dk, dv);
  return cudaGetLastError();
}
