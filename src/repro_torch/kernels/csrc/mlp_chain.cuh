// Shared pieces of the fused MLP kernels (sm_90a, fp32 FFMA).
//
// A CTA owns kRows consecutive rows of x (B, H) and keeps their activation
// tile h (kRows x H fp32, 64 KB at H = 1024) in shared memory across all L
// layers, so activations never leave the chip between layers.  Thread g of
// the CTA owns the output column group [4g, 4g + 4) of every layer and
// accumulates its kRows x 4 outputs in registers, streaming the layer's
// weight columns (W is (in, out) row-major, as the reference packs it)
// with 16-byte loads: the 32 threads of a warp read 512 contiguous bytes
// of one weight row.  Each weight float4 feeds kRows x 4 FMAs.  H must be
// a multiple of 4 and at most 4 * kThreads (one column group per thread).
#pragma once

#include <cuda_runtime.h>

#include "cuda_error.cuh"

namespace repro_mlp {

constexpr int kRows = 16;      // rows per CTA (h tile: kRows x H fp32)
constexpr int kThreads = 256;  // one float4 column group per thread

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& w) {
  acc.x = fmaf(a, w.x, acc.x);
  acc.y = fmaf(a, w.y, acc.y);
  acc.z = fmaf(a, w.z, acc.z);
  acc.w = fmaf(a, w.w, acc.w);
}

__device__ __forceinline__ float4 add4(const float4& a, const float4& b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 relu4(const float4& a) {
  return make_float4(fmaxf(a.x, 0.f), fmaxf(a.y, 0.f), fmaxf(a.z, 0.f),
                     fmaxf(a.w, 0.f));
}

// Copy the CTA's kRows rows of x (row-major, H wide) into shared memory;
// rows past the first `rows` (a ragged tail) read as zero.
__device__ __forceinline__ void load_rows(float* h, const float* x,
                                          long long row0, int rows, int H) {
  const float4* src = reinterpret_cast<const float4*>(x + row0 * H);
  float4* dst = reinterpret_cast<float4*>(h);
  const int n = rows * (H >> 2);
  for (int i = threadIdx.x; i < kRows * (H >> 2); i += blockDim.x) {
    dst[i] = i < n ? src[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// acc[r] = sum_i h[r][i] * w[i][4g .. 4g + 3] for the CTA's kRows rows.
__device__ __forceinline__ void layer_product(const float* __restrict__ h,
                                              const float* __restrict__ w,
                                              int H, int g,
                                              float4 (&acc)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int H4 = H >> 2;
  const float4* wcol = reinterpret_cast<const float4*>(w) + g;
  for (int i = 0; i < H; i += 4) {
    const float4 w0 = __ldg(wcol + (long long)(i + 0) * H4);
    const float4 w1 = __ldg(wcol + (long long)(i + 1) * H4);
    const float4 w2 = __ldg(wcol + (long long)(i + 2) * H4);
    const float4 w3 = __ldg(wcol + (long long)(i + 3) * H4);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(h + r * H + i);
      fma4(acc[r], a.x, w0);
      fma4(acc[r], a.y, w1);
      fma4(acc[r], a.z, w2);
      fma4(acc[r], a.w, w3);
    }
  }
}

// One MLP's L-layer chain on the CTA's tile h, in place:
// h <- relu(h @ w[l] + b[l]) for l < L - 1, no ReLU after the last layer.
// w is (L, H, H) and b (L, H).  Thread g owns column group g; h is
// rewritten only once every thread has finished reading it.
__device__ __forceinline__ void run_chain(float* h,
                                          const float* __restrict__ w,
                                          const float* __restrict__ b, int H,
                                          int L) {
  const int g = threadIdx.x;
  const int H4 = H >> 2;
  float4* h4 = reinterpret_cast<float4*>(h);
  float4 acc[kRows];
  for (int l = 0; l < L; ++l) {
    if (g < H4) {
      layer_product(h, w + static_cast<long long>(l) * H * H, H, g, acc);
    }
    __syncthreads();  // every thread has finished reading h
    if (g < H4) {
      const float4 bias =
          reinterpret_cast<const float4*>(b + static_cast<long long>(l) * H)[g];
      const bool last = l == L - 1;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 z = add4(acc[r], bias);
        h4[r * H4 + g] = last ? z : relu4(z);
      }
    }
    __syncthreads();
  }
}

// Host-side shape contract shared by the launchers (B in whole kRows
// tiles: the ragged fused_mlp passes B rounded up).
inline bool shapes_ok(int B, int H, int L, int K) {
  return B > 0 && B % kRows == 0 && H > 0 && H % 4 == 0 &&
         H / 4 <= kThreads && L > 0 && K > 0 && K <= 32;
}

}  // namespace repro_mlp
