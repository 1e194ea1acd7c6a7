// One MLP's fused layer chain for Hopper (sm_90a), fp32 FFMA, no TF32.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_mlp.py:51 (fused_mlp,
// body _mlp_kernel :30).  Computes, for each row i of x (B, H), the L-layer
// chain h <- relu(h @ W[l] + b[l]) for l < L - 1, no ReLU after the last
// layer, and writes column 0 of the last layer to out[i].  The host packs
// the trained MLP into uniform (L, H, H) / (L, H) blocks (the 13 input
// features and the single output zero-padded to H).  B is any positive
// count: the last CTA masks its tail (zero rows in, no write out), so the
// host pads nothing.
//
// What bounds it on an H100: FLOPs.  A row needs, of the packed chain,
// the first layer over its real inputs (2 * 13 * H: the packing pads the
// 13 features with zeros), the hidden layers whole (2 * H^2 each) and only
// column 0 of the last layer (2 * H): at the paper's MLPConfig (L = 9,
// H = 1024) 14.7 MFLOP a row against 52 B of real input, and the weights
// it needs (about (L - 2) * H^2 * 4 B = 29.4 MB) are read once per launch.
// At the 6,000 test rows of a trained predictor that is 88.3 GFLOP, far
// above the fp32 ridge point (67 TFLOP/s over 3.35 TB/s = 20 FLOP/B), so
// the floor is FLOPs / fp32 FFMA peak: 1.32 ms.  The kernel itself runs
// every packed layer whole (L * 2 * H^2 = 18.9 MFLOP a row), 28% more.
//
// What the design does about it: the TPU kernel keeps a (256, H) tile in
// VMEM across a sequential layer grid axis; at H = 1024 that is 1 MB, which
// fits no CTA.  Here, with the scorers' chain (mlp_chain.cuh), a CTA
// takes kRows = 16 rows, keeps their activations in shared memory across
// all L layers (64 KB at H = 1024, updated in place once every thread has
// read h), and loops over the layers itself; thread g owns output columns
// [4g, 4g + 4) and each 16-byte weight load feeds 64 FMAs from registers.
// Known limit: at H = 256 (the default predictor) only 64 of the 256
// threads own a column group.  wgmma, TMA and persistent scheduling are
// later work.
#include "mlp_chain.cuh"

namespace {

using namespace repro_mlp;

__global__ void __launch_bounds__(kThreads, 2)
mlp_kernel(const float* __restrict__ x, const float* __restrict__ weights,
           const float* __restrict__ biases, float* __restrict__ out, int B,
           int H, int L) {
  extern __shared__ float4 smem[];
  float* h = reinterpret_cast<float*>(smem);
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = min(kRows, static_cast<int>(B - row0));
  load_rows(h, x, row0, rows, H);  // the tail past B reads as zero
  __syncthreads();
  run_chain(h, weights, biases, H, L);
  if (threadIdx.x < rows) out[row0 + threadIdx.x] = h[threadIdx.x * H];
}

}  // namespace

// x (B, H) f32, weights (L, H, H) f32, biases (L, H) f32 -> out (B,) f32.
// Returns a cudaError_t (0 = ok).
extern "C" int repro_fused_mlp(const float* x, const float* weights,
                               const float* biases, float* out, int B, int H,
                               int L, void* stream) {
  if (B <= 0 || !shapes_ok((B + kRows - 1) / kRows * kRows, H, L, 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = kRows * H * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mlp_kernel<<<(B + kRows - 1) / kRows, kThreads, smem,
               static_cast<cudaStream_t>(stream)>>>(x, weights, biases, out,
                                                    B, H, L);
  return static_cast<int>(cudaGetLastError());
}
