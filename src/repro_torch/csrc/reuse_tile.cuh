// Shared device code of the block-skip ΔW GEMMs (reuse_matmul.cu and
// reuse_matmul_ragged.cu): O = prev_out + Σ_k mask[m,k] · Δ[m,k] · W[k,n].
//
// Decode has M = serving batch ≤ 8 rows, so the product is a matrix–vector
// product in disguise: about 8 FLOP per weight byte against the ~295 the
// H100 needs before its tensor cores become the limit. The weight stream is
// the whole cost. These helpers stream each weight row of a tile once, as
// 16-byte loads that neighbouring threads issue on neighbouring addresses,
// and accumulate in f32 on the CUDA cores (no TF32 for f32 operands).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace reuse {

constexpr int kRows = 8;       // output rows per CTA (one decode m-tile)
constexpr int kThreads = 256;  // threads per CTA
constexpr int kChunkRows = 8;  // weight rows each thread has in flight

// Elements of T in one 16-byte load.
template <typename T>
struct Vec {
  static constexpr int n = 16 / sizeof(T);
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 16 bytes of T -> Vec<T>::n floats.
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);            // low half: element 2i
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Output-stationary tile walker. One CTA owns an (8-row, 128-column) output
// tile. Thread t covers columns (t % kTpr) * kVec .. + kVec of the tile and
// weight rows r ≡ t / kTpr (mod kGroups) of every active k-tile, so one
// weight row is read by kTpr neighbouring threads as one contiguous burst.
template <typename T>
struct OutputTile {
  static constexpr int kVec = Vec<T>::n;            // 8 bf16 / 4 f32
  static constexpr int kCols = 128;                 // output columns per CTA
  static constexpr int kTpr = kCols / kVec;         // 16 bf16 / 32 f32
  static constexpr int kGroups = kThreads / kTpr;   // 16 bf16 / 8 f32
  static constexpr int kChunk = kGroups * kChunkRows;  // rows per chunk
  static constexpr int kWarps = kThreads / 32;

  struct Smem {
    float delta[kRows][kChunk];               // Δ rows of the current chunk
    float red[kWarps][kRows][kCols];          // per-warp partial sums
  };

  float acc[kRows][kVec];
  int col, group;

  __device__ __forceinline__ OutputTile() {
    col = (threadIdx.x % kTpr) * kVec;
    group = threadIdx.x / kTpr;
#pragma unroll
    for (int m = 0; m < kRows; ++m)
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[m][j] = 0.f;
  }

  // Accumulate one active k-tile: rows [k0, k0 + block_k) of W, columns
  // [n0, n0 + 128), against Δ rows [m0, m0 + 8). Called uniformly by the
  // whole CTA (it synchronises).
  __device__ __forceinline__ void add_ktile(
      Smem& s, const T* __restrict__ delta, const T* __restrict__ w,
      int K, int N, int m0, int n0, int k0, int block_k) {
    for (int c0 = 0; c0 < block_k; c0 += kChunk) {
      const int rows = min(kChunk, block_k - c0);
      __syncthreads();  // the previous chunk's Δ reads are done
      for (int e = threadIdx.x; e < kRows * kChunk; e += kThreads) {
        const int m = e / kChunk, r = e % kChunk;
        s.delta[m][r] =
            r < rows ? to_f32(delta[(size_t)(m0 + m) * K + k0 + c0 + r]) : 0.f;
      }
      __syncthreads();
      uint4 buf[kChunkRows];
#pragma unroll
      for (int i = 0; i < kChunkRows; ++i) {
        const int r = group + i * kGroups;
        buf[i] = r < rows ? *reinterpret_cast<const uint4*>(
                                w + (size_t)(k0 + c0 + r) * N + n0 + col)
                          : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int i = 0; i < kChunkRows; ++i) {
        float wf[kVec];
        unpack(buf[i], wf);
        const int r = group + i * kGroups;
#pragma unroll
        for (int m = 0; m < kRows; ++m) {
          const float d = s.delta[m][r];
#pragma unroll
          for (int j = 0; j < kVec; ++j) acc[m][j] = fmaf(d, wf[j], acc[m][j]);
        }
      }
    }
  }

  // Reduce the row groups and write out = prev_out + Σ (fixed order).
  __device__ __forceinline__ void finish(
      Smem& s, const float* __restrict__ prev_out, float* __restrict__ out,
      int N, int m0, int n0) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    if (kTpr == 16) {  // two row groups per warp: fold lanes l and l ^ 16
#pragma unroll
      for (int m = 0; m < kRows; ++m)
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], 16);
    }
    if (lane < kTpr) {
#pragma unroll
      for (int m = 0; m < kRows; ++m)
#pragma unroll
        for (int j = 0; j < kVec; ++j) s.red[warp][m][col + j] = acc[m][j];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kRows * kCols; e += kThreads) {
      const int m = e / kCols, c = e % kCols;
      const size_t o = (size_t)(m0 + m) * N + n0 + c;
      float v = prev_out[o];
#pragma unroll
      for (int q = 0; q < kWarps; ++q) v += s.red[q][m][c];
      out[o] = v;
    }
  }
};

}  // namespace reuse
