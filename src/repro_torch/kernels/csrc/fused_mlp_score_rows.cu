// Row-mapped fused MLP scorer for Hopper (sm_90a), fp32 FFMA, no TF32.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_mlp_score.py:237
// (fused_mlp_score_rows, body _score_rows_kernel :169, scalar-prefetch
// maps _row_kind_maps :217).  Row i of x (B, H) flows through the L-layer
// chain of its OWN kind row_kinds[i] (ReLU between layers, none after the
// last) and out[i] is column 0 of the last layer, so callers with any
// kind mix score everything in one launch.  A row's result is exactly its
// own kind's forward.  Padding rows carry kind 0; their outputs are
// garbage by contract.
//
// What bounds it on an H100: FLOPs, as for the block-mapped kernel —
// 14.7 MFLOP a row needs at the paper's MLPConfig (the first layer over 13
// real inputs, column 0 of the last) against 29.4 MB of weights per kind.
// A CTA holding rows of m kinds does m layer products per layer, so a
// mixed CTA costs m times the FLOPs its rows need.
//
// What the design does about it: no scalar-prefetch maps.  Each CTA loads
// its own kRows = 16 rows' kinds and builds a kind-presence bit mask; per
// layer it runs only the present kinds' products (absent kinds skip both
// compute and weight traffic) and keeps each kind's results for that
// kind's rows in a second shared tile z.  h and z are 64 KB each at
// H = 1024 (128 KB of dynamic shared memory).  The engine appends cold
// cells kind by kind, so most CTAs hold one kind and pay one product.
#include "mlp_chain.cuh"

namespace {

using namespace repro_mlp;

__global__ void __launch_bounds__(kThreads, 1)
score_rows_kernel(const float* __restrict__ x,
                  const int* __restrict__ row_kinds,
                  const float* __restrict__ weights,
                  const float* __restrict__ biases, float* __restrict__ out,
                  int H, int L, int K) {
  extern __shared__ float4 smem[];
  float* h = reinterpret_cast<float*>(smem);
  float4* h4 = smem;
  float4* z4 = smem + kRows * (H >> 2);
  __shared__ int s_kind[kRows];
  __shared__ unsigned s_present;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  if (threadIdx.x == 0) s_present = 0u;
  load_rows(h, x, row0, kRows, H);
  __syncthreads();
  if (threadIdx.x < kRows) {
    const int k = row_kinds[row0 + threadIdx.x];
    s_kind[threadIdx.x] = k;
    if (k >= 0 && k < K) atomicOr(&s_present, 1u << k);
  }
  __syncthreads();
  const unsigned present = s_present;
  const int g = threadIdx.x;
  const int H4 = H >> 2;
  float4 acc[kRows];
  for (int l = 0; l < L; ++l) {
    for (unsigned m = present; m; m &= m - 1) {
      const int k = __ffs(static_cast<int>(m)) - 1;
      const long long layer = static_cast<long long>(k) * L + l;
      if (g < H4) {
        layer_product(h, weights + layer * H * H, H, g, acc);
        const float4 b =
            reinterpret_cast<const float4*>(biases + layer * H)[g];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (s_kind[r] == k) z4[r * H4 + g] = add4(acc[r], b);
        }
      }
    }
    __syncthreads();  // every present kind has finished reading h
    if (g < H4) {
      const bool last = l == L - 1;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 z = z4[r * H4 + g];
        h4[r * H4 + g] = last ? z : relu4(z);
      }
    }
    __syncthreads();
  }
  if (threadIdx.x < kRows) {
    const int k = s_kind[threadIdx.x];
    out[row0 + threadIdx.x] =
        (k >= 0 && k < K) ? h[threadIdx.x * H] : __int_as_float(0x7fc00000);
  }
}

}  // namespace

// x (B, H) f32, row_kinds (B,) i32, weights (K, L, H, H) f32,
// biases (K, L, H) f32 -> out (B,) f32.  Returns a cudaError_t (0 = ok).
extern "C" int repro_fused_mlp_score_rows(const float* x, const int* row_kinds,
                                          const float* weights,
                                          const float* biases, float* out,
                                          int B, int H, int L, int K,
                                          void* stream) {
  if (!shapes_ok(B, H, L, K)) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 2 * kRows * H * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      score_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  score_rows_kernel<<<B / kRows, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      x, row_kinds, weights, biases, out, H, L, K);
  return static_cast<int>(cudaGetLastError());
}
