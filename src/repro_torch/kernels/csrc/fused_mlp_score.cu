// Block-mapped fused MLP scorer for Hopper (sm_90a), 3xTF32 on the tensor
// cores.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_mlp_score.py:125
// (fused_mlp_score, body _score_kernel :103).  Computes, for each row i of
// x (B, H), the L-layer chain of MLP kind block_kinds[i / block_m]:
// h <- relu(h @ W[k, l] + b[k, l]) for l < L - 1, no ReLU after the last
// layer, and writes column 0 of the last layer to out[i].  Rows arrive
// grouped by kind and padded to whole block_m blocks (the host does that).
//
// What bounds it on an H100: operations.  A row needs, of its kind's packed
// chain, the first layer over its 13 real inputs, the hidden layers whole
// and only column 0 of the last: 2 * 13 * H + (L - 2) * 2 * H^2 + 2 * H =
// 14.7 MFLOP at the paper's MLPConfig (L = 9, H = 1024) against 52 B of
// real input; one kind's weights are about 29.4 MB of that.  At tens of
// thousands of rows a launch is ~1e12 FLOP and reads at most 4 x 29.4 MB
// of weights, far above the ridge point, so the floor is the FLOPs at
// fp32 accuracy, each product as three tf32 products at the 495 TFLOP/s
// dense tf32 rate (fp32 FFMA, at 67 TFLOP/s, gives about 2.5x less).
//
// What the design does about it (mlp_gemm.cuh): each layer is one tiled
// GEMM over all rows on mma.sync.m16n8k8 in 3xTF32, 128-row tiles of one
// kind (one pass of the GEMM's loop over the kinds in a tile) by 128
// columns, each weight byte feeding 64 FLOP; activations pass between the
// layers through two (B, H) scratch buffers.  No padded work:
// the first layer runs over in_features columns (rounded up to 8) and the
// last over one 8-column tile.  The port's first kernel looped over the
// layers with 16 rows a CTA on fp32 FFMA and ran every packed layer whole.
// wgmma needs a K-major B in tf32, a transposed weight pack: later work.
#include "mlp_gemm.cuh"

// x (B, H) f32, block_kinds (B / block_m,) i32, weights (K, L, H, H) f32,
// biases (K, L, H) f32 -> out (B,) f32; scratch0 and scratch1 are (B, H) f32
// (unused when L = 1).  Rows in_features.. of every W[k, 0] must be zero.
// Launches L kernels on the stream; returns a cudaError_t (0 = ok).
extern "C" int repro_fused_mlp_score(const float* x, const int* block_kinds,
                                     const float* weights,
                                     const float* biases, float* out,
                                     float* scratch0, float* scratch1, int B,
                                     int H, int L, int K, int block_m,
                                     int in_features, void* stream) {
  if (B <= 0 || H <= 0 || H % 4 || L <= 0 || K <= 0 || K > 32 ||
      block_m <= 0 || block_m % 16 || B % block_m || in_features <= 0 ||
      in_features > H) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const repro_mlp_tc::Chain chain{x, block_kinds, weights, biases, out,
                                  {scratch0, scratch1}, B, H, L, K, block_m,
                                  in_features};
  return repro_mlp_tc::launch_chain(chain, stream);
}
