// Row-mapped fused MLP scorer for Hopper (sm_90a), 3xTF32 on the tensor
// cores.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_mlp_score.py:237
// (fused_mlp_score_rows, body _score_rows_kernel :169, scalar-prefetch
// maps _row_kind_maps :217).  Row i of x (B, H) flows through the L-layer
// chain of its OWN kind row_kinds[i] (ReLU between layers, none after the
// last) and out[i] is column 0 of the last layer, so callers with any
// kind mix score everything in one launch.  A row's result is exactly its
// own kind's forward.  A row whose kind lies outside [0, K) gives NaN and
// leaves the other rows unchanged (the reference's contract asks for a
// valid kind on every row; this keeps a bad one from reading wild memory).
//
// What bounds it on an H100: operations, as for the block-mapped kernel.
// A row needs, of its kind's packed chain, the first layer over its 13
// real inputs, the hidden layers whole and only column 0 of the last:
// 14.7 MFLOP at the paper's MLPConfig (L = 9, H = 1024) against 52 B of
// real input, and a launch reads at most the K kinds' weights (about
// 29.4 MB each).  At the tens of thousands of rows of a cell-masked sweep
// that is far above the ridge point, so the floor is the FLOPs at fp32
// accuracy, each product as three tf32 products at the 495 TFLOP/s dense
// tf32 rate.
//
// What the design does about it: the block scorer's layer GEMMs
// (mlp_gemm.cuh) with a kind per row (block_m 1).  Each 128-row tile runs
// its k loop once per kind present in it, over that kind's weights, and
// writes each row in its own kind's pass, so a mixed tile pays one
// product per kind present.  The engine appends the cold cells kind by
// kind and pads the tail with the last row's kind, so all but a few tiles
// hold one kind and pay one product, as a block tile does.  No padded
// work: the first layer runs over in_features columns (rounded up to 8)
// and the last over one 8-column tile.  The port's first row kernel ran
// 16-row CTAs on fp32 FFMA with the activations in shared memory, each
// weight float4 feeding 16 x 4 FMAs, and every packed layer whole.
#include "mlp_gemm.cuh"

// x (B, H) f32, row_kinds (B,) i32, weights (K, L, H, H) f32,
// biases (K, L, H) f32 -> out (B,) f32; scratch0 and scratch1 are (B, H) f32
// (unused when L = 1).  Rows in_features.. of every W[k, 0] must be zero.
// Launches L kernels on the stream; returns a cudaError_t (0 = ok).
extern "C" int repro_fused_mlp_score_rows(const float* x, const int* row_kinds,
                                          const float* weights,
                                          const float* biases, float* out,
                                          float* scratch0, float* scratch1,
                                          int B, int H, int L, int K,
                                          int in_features, void* stream) {
  if (B <= 0 || H <= 0 || H % 4 || L <= 0 || K <= 0 || K > 32 ||
      in_features <= 0 || in_features > H) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const repro_mlp_tc::Chain chain{x, row_kinds, weights, biases, out,
                                  {scratch0, scratch1}, B, H, L, K, 1,
                                  in_features};
  return repro_mlp_tc::launch_chain(chain, stream);
}
