// One MLP's fused layer chain for Hopper (sm_90a), 3xTF32 on the tensor
// cores.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_mlp.py:51 (fused_mlp,
// body _mlp_kernel :30).  Computes, for each row i of x (B, H), the L-layer
// chain h <- relu(h @ W[l] + b[l]) for l < L - 1, no ReLU after the last
// layer, and writes column 0 of the last layer to out[i].  The host packs
// the trained MLP into uniform (L, H, H) / (L, H) blocks (the 13 input
// features and the single output zero-padded to H).  B is any positive
// count: the kernels zero-fill the rows past B and write none of them, so
// the host pads nothing.
//
// What bounds it on an H100: operations.  A row needs, of the packed
// chain, the first layer over its real inputs (2 * 13 * H), the hidden
// layers whole (2 * H^2 each) and only column 0 of the last layer (2 * H):
// at the paper's MLPConfig (L = 9, H = 1024) 14.7 MFLOP a row against 52 B
// of real input, and the weights it needs (about (L - 2) * H^2 * 4 B =
// 29.4 MB) are read once per launch.  At the 6,000 test rows of a trained
// predictor that is 88.3 GFLOP, far above the ridge point, so the floor is
// the FLOPs at fp32 accuracy, each product as three tf32 products at the
// 495 TFLOP/s dense tf32 rate: 0.535 ms (1.317 ms on fp32 FFMA).
//
// What the design does about it: the block scorer's layer GEMMs
// (mlp_gemm.cuh) with one kind, so the row tile is free: 128 rows, or
// fewer where 128-row tiles would not give every SM a CTA (6,000 rows at
// H = 256).  The first layer runs over in_features columns (rounded up to
// 8), the last over one 8-column tile.  The port's first kernel looped
// over the layers with 16 rows a CTA on fp32 FFMA, one column group a
// thread, so at H = 256 three quarters of its threads idled.
#include "mlp_gemm.cuh"

// x (B, H) f32, weights (L, H, H) f32, biases (L, H) f32 -> out (B,) f32;
// scratch0 and scratch1 are (B, H) f32 (unused when L = 1).  Rows
// in_features.. of W[0] must be zero.  Launches L kernels on the stream;
// returns a cudaError_t (0 = ok).
extern "C" int repro_fused_mlp(const float* x, const float* weights,
                               const float* biases, float* out,
                               float* scratch0, float* scratch1, int B, int H,
                               int L, int in_features, void* stream) {
  if (B <= 0 || H <= 0 || H % 4 || L <= 0 || in_features <= 0 ||
      in_features > H) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const repro_mlp_tc::Chain chain{x, nullptr, weights, biases, out,
                                  {scratch0, scratch1}, B, H, L, 1, 0,
                                  in_features};
  return repro_mlp_tc::launch_chain(chain, stream);
}
