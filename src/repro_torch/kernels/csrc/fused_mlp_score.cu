// Block-mapped fused MLP scorer for Hopper (sm_90a), fp32 FFMA, no TF32.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_mlp_score.py:125
// (fused_mlp_score, body _score_kernel :103).  Computes, for each row i of
// x (B, H), the L-layer chain of MLP kind block_kinds[i / block_m]:
// h <- relu(h @ W[k, l] + b[k, l]) for l < L - 1, no ReLU after the last
// layer, and writes column 0 of the last layer to out[i].  Rows arrive
// grouped by kind and padded to whole block_m blocks (the host does that).
//
// What bounds it on an H100: FLOPs.  A row needs, of its kind's packed
// chain, the first layer over its 13 real inputs, the hidden layers whole
// and only column 0 of the last: 2 * 13 * H + (L - 2) * 2 * H^2 + 2 * H =
// 14.7 MFLOP at the paper's MLPConfig (L = 9, H = 1024; the kernel runs
// every packed layer whole, L * 2 * H^2 = 18.9 MFLOP) against 52 B of
// real input; one kind's weights are about 29.4 MB of that.  At tens of
// thousands of rows a launch is ~1e12 FLOP and reads at most 4 x 29.4 MB
// of weights, far above the fp32 ridge point (67 TFLOP/s over 3.35 TB/s =
// 20 FLOP/B), so the floor is FLOPs / fp32 FFMA peak.
//
// What the design does about it: the TPU kernel keeps a (128, H) tile in
// VMEM across a sequential layer axis; 512 KB does not fit the 227 KB of
// shared memory a CTA may use.  Here a CTA takes kRows = 16 rows, keeps
// their activations on chip across all layers (64 KB of shared memory,
// updated in place: every thread finishes reading h before any writes),
// and loops over the layers itself.  The block_m = 128 host padding unit
// is unchanged, so a CTA's kind is block_kinds[row / block_m].  Weights
// stream from L2 (a 4 MB layer is shared by all CTAs in flight); each
// 16-byte weight load feeds 64 FMAs from registers.  A simple, right
// kernel: wgmma, TMA and persistent scheduling are later work.
#include "mlp_chain.cuh"

namespace {

using namespace repro_mlp;

__global__ void __launch_bounds__(kThreads, 2)
score_kernel(const float* __restrict__ x, const int* __restrict__ block_kinds,
             const float* __restrict__ weights,
             const float* __restrict__ biases, float* __restrict__ out,
             int H, int L, int K, int block_m) {
  extern __shared__ float4 smem[];
  float* h = reinterpret_cast<float*>(smem);
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int kind = block_kinds[row0 / block_m];
  if (kind < 0 || kind >= K) {  // out-of-range kind: NaN, never a wild read
    if (threadIdx.x < kRows) out[row0 + threadIdx.x] = __int_as_float(0x7fc00000);
    return;
  }
  load_rows(h, x, row0, kRows, H);
  __syncthreads();
  const long long first = static_cast<long long>(kind) * L;
  run_chain(h, weights + first * H * H, biases + first * H, H, L);
  if (threadIdx.x < kRows) out[row0 + threadIdx.x] = h[threadIdx.x * H];
}

}  // namespace

// x (B, H) f32, block_kinds (B / block_m,) i32, weights (K, L, H, H) f32,
// biases (K, L, H) f32 -> out (B,) f32.  Returns a cudaError_t (0 = ok).
extern "C" int repro_fused_mlp_score(const float* x, const int* block_kinds,
                                     const float* weights,
                                     const float* biases, float* out, int B,
                                     int H, int L, int K, int block_m,
                                     void* stream) {
  if (!shapes_ok(B, H, L, K) || block_m <= 0 || block_m % kRows ||
      B % block_m) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = kRows * H * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  score_kernel<<<B / kRows, kThreads, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      x, block_kinds, weights, biases, out, H, L, K, block_m);
  return static_cast<int>(cudaGetLastError());
}
