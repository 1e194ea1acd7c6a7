// An MLP's layer chain on Hopper's tensor cores (sm_90a): one tiled GEMM a
// layer, fp32 accuracy from three tf32 products (3xTF32).
//
// Shared by the three MLP kernels: the block-mapped scorer
// (fused_mlp_score.cu, a kind per block_m rows), the row-mapped scorer
// (fused_mlp_score_rows.cu, a kind a row) and the single-MLP chain
// (fused_mlp.cu, one kind).  The chain h <- relu(h @ W[l] + b[l]) for
// l < L - 1, no ReLU after the last layer, returns column 0 of the last
// layer.  It runs as L launches of one kernel on the caller's stream:
//   - layer 0 reads x over its first k_in columns only (k_in = in_features
//     rounded up to the MMA depth of 8: the packing leaves rows
//     in_features.. of W[0] zero, so the columns skipped add nothing);
//   - the hidden layers write and read two (B, H) fp32 scratch buffers in
//     turn (the wrapper allocates them);
//   - the last layer computes one 8-column n-tile and writes column 0.
// A TPU kernel keeps a (128, H) activation tile in VMEM across the layers;
// at H = 1024 that tile is 512 KB and fits in no CTA (227 KB of shared
// memory), so here the activations go through device memory, mostly L2.
//
// One layer, Y = act(X W + b), X (B, K) with row stride H, W (K, N) with
// row stride H (W is (in, out), as the reference packs it): a CTA owns a
// BM x BN output tile and walks K in steps of BK = 32 through a 3-stage
// cp.async ring of an A tile (BM x 32) and a B tile (32 x BN) in shared
// memory.  The edges of K and N and the rows past B are zero-filled in
// shared memory (cp.async with 0 source bytes), so every H that is a
// multiple of 4 and any B run the same code.  Hidden layers take BN = 128
// with 8 warps; a warp owns a (16 MT) x (8 NT) sub-tile, 64 x 32 at
// BM = 128.  The CTAs of one row tile are adjacent in the grid, so its A
// tile is read from L2 by all of them, and a layer of weights (4 MB at
// H = 1024, 16 MB for four kinds) stays in the 50 MB L2.
//
// Kinds: a CTA stages its BM rows' kinds in shared memory and ORs them
// into a presence mask, then runs the whole k loop once per kind present,
// over that kind's W[k, l], and its epilogue writes a row only in the pass
// of the row's own kind.  A tile of one kind (every block-scorer tile: the
// host takes a BM that divides block_m; every single-MLP tile) runs one
// pass.  A row whose kind lies outside [0, n_kinds) is in no pass: the
// hidden layers never write its scratch row, and the last layer writes
// NaN for it, never a wild read; the other rows of its tile are unchanged.
//
// Each fp32 operand v goes into mma.sync.m16n8k8 as hi = tf32(v) and
// lo = tf32(v - hi) (round to nearest, ties away from zero, as cvt.rna
// rounds), and each product as a_lo b_hi + a_hi b_lo + a_hi b_hi, the
// small terms first (warp_mma.cuh).  Fragments are split once after their
// ld.shared and reused across the warp's tiles: a B fragment by all MT
// row tiles, an A fragment by all NT column tiles.  Rows of the A tile
// are padded to 36 floats and of the B tile to BN + 8, so the 32 lanes of
// a fragment load hit 32 distinct banks.
//
// The tensor cores' adder truncates each MMA's sum toward zero.  Over a
// 1024-deep layer in one accumulator (384 MMAs) those truncations all
// lean one way and, through 9 layers, reach the path's 1e-4 gate on
// log-ms.  So the MMAs sum one 32-deep k-step from zero (12 MMAs) and an
// fp32 FADD adds that partial to the layer's sum, which keeps the error
// near fp32 FFMA's (tests/test_torch_kernel_numerics.py emulates both).
// The partial and the sum take 64 registers each at BM = 128, so that
// tile runs one CTA of 8 warps an SM; the smaller tiles fit 128
// registers and run two.
#pragma once

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

#include "cuda_error.cuh"
#include "warp_mma.cuh"

namespace repro_mlp_tc {

constexpr int kStages = 3;
constexpr int kBK = 32;

// What one layer launch reads and writes.  w and b point at kind 0's layer;
// kind k's is w_kind (b_kind) floats further on.
struct LayerArgs {
  const float* src;   // activations in, (B, K) of row stride H
  const float* w;     // (K, N) of row stride H
  const float* b;     // (N,)
  float* dst;         // activations out, (B, N) of row stride H; the last
                      // layer: out (B,), column 0
  const int* kinds;   // a kind per block_m rows (block_m 1: a kind a
                      // row), or nullptr: kind 0
  long long w_kind, b_kind;
  int B, H, K, N;
  int block_m, n_kinds;
};

// A CTA of WM x WN warps, each owning MT x NT MMA tiles (16 x 8 each).
template <int WM, int WN, int MT, int NT, bool kLast>
struct Tile {
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int BM = 16 * WM * MT, BN = 8 * WN * NT;
  static constexpr int kAStride = kBK + 4;                 // 4 banks a row
  static constexpr int kBStride = BN % 32 ? BN : BN + 8;   // 8 banks a row
  static constexpr int kStageFloats = BM * kAStride + kBK * kBStride;
  static constexpr int kSmem = kStages * kStageFloats * 4;
  static constexpr int kMinBlocks = MT * NT > 8 ? 1 : 2;  // CTAs an SM
  static_assert(!kLast || BN == 8, "the last layer computes one n-tile");
  static_assert((kAStride * 4) % 16 == 0 && (kBStride * 4) % 16 == 0,
                "cp.async needs 16-byte rows");
  static_assert(kThreads >= BM, "a thread stages each row's kind");
};

// The tiles of each row-tile size: hidden layers (BN = 128, 8 warps) and
// the last layer (BN = 8, one warp per 16 rows).
template <int BM> struct Tiles;
template <> struct Tiles<128> {
  using Hidden = Tile<2, 4, 4, 4, false>;
  using Last = Tile<8, 1, 1, 1, true>;
};
template <> struct Tiles<64> {
  using Hidden = Tile<2, 4, 2, 4, false>;
  using Last = Tile<4, 1, 1, 1, true>;
};
template <> struct Tiles<32> {
  using Hidden = Tile<2, 4, 1, 4, false>;
  using Last = Tile<2, 1, 1, 1, true>;
};
template <> struct Tiles<16> {
  using Hidden = Tile<1, 8, 1, 2, false>;
  using Last = Tile<1, 1, 1, 1, true>;
};

// The cp.async copies of one thread, fixed for a CTA's whole k loop: its
// c-th 16-byte chunk of the A tile is row ra + c * kARows, columns ca..ca+3,
// and of the B tile row rb + c * kBRows, columns cb..cb+3.
template <class T>
struct Loader {
  static constexpr int kAChunks = T::BM * (kBK / 4);
  static constexpr int kBChunks = kBK * (T::BN / 4);
  static constexpr int kA = (kAChunks + T::kThreads - 1) / T::kThreads;
  static constexpr int kB = (kBChunks + T::kThreads - 1) / T::kThreads;
  static constexpr int kARows = T::kThreads / (kBK / 4);
  static constexpr int kBRows = T::kThreads / (T::BN / 4);
  static_assert(T::kThreads % (T::BN / 4) == 0, "whole B rows a pass");

  const LayerArgs& p;
  const float* a;  // x at row row0 + ra, column ca
  const float* b;  // W at row rb, column n0 + cb
  long long row;   // row0 + ra
  int ra, ca, rb, cb;
  bool b_ok;       // column n0 + cb < N

  __device__ __forceinline__ Loader(const LayerArgs& args, const float* w,
                                    long long row0, int n0)
      : p(args) {
    ra = threadIdx.x / (kBK / 4);
    ca = threadIdx.x % (kBK / 4) * 4;
    rb = threadIdx.x / (T::BN / 4);
    cb = threadIdx.x % (T::BN / 4) * 4;
    row = row0 + ra;
    a = p.src + row * p.H + ca;
    b = w + static_cast<long long>(rb) * p.H + n0 + cb;
    b_ok = n0 + cb < p.N;
  }

  // Stage the A tile (columns k0..) and the B tile (rows k0..) of one
  // k-step; what lies past B, K or N is zero-filled.
  __device__ __forceinline__ void operator()(float* stage, int k0) const {
#pragma unroll
    for (int c = 0; c < kA; ++c) {
      const int r = ra + c * kARows;
      if (kAChunks % T::kThreads == 0 || r < T::BM) {
        const bool ok = row + c * kARows < p.B && k0 + ca < p.K;
        warp_mma::cp_async_16(
            stage + r * T::kAStride + ca,
            ok ? a + static_cast<long long>(c * kARows) * p.H + k0 : p.src,
            ok ? 16 : 0);
      }
    }
    float* bs = stage + T::BM * T::kAStride;
#pragma unroll
    for (int c = 0; c < kB; ++c) {
      const int r = rb + c * kBRows;
      if (kBChunks % T::kThreads == 0 || r < kBK) {
        const bool ok = b_ok && k0 + r < p.K;
        warp_mma::cp_async_16(
            bs + r * T::kBStride + cb,
            ok ? b + static_cast<long long>(k0 + c * kBRows) * p.H : p.src,
            ok ? 16 : 0);
      }
    }
  }
};

// part += the warp's share of A B over one staged k-step, 3xTF32.
template <class T, int MT, int NT>
__device__ __forceinline__ void mma_stage(const float* stage, int m_warp,
                                          int n_warp, int g, int t,
                                          float (&part)[MT][NT][4]) {
  const float* as = stage + (m_warp + g) * T::kAStride + t;
  const float* bs =
      stage + T::BM * T::kAStride + t * T::kBStride + n_warp + g;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 8) {
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      warp_mma::split_tf32(bs[kk * T::kBStride + 8 * j], bh[j][0], bl[j][0]);
      warp_mma::split_tf32(bs[(kk + 4) * T::kBStride + 8 * j], bh[j][1],
                           bl[j][1]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const float* a = as + 16 * i * T::kAStride + kk;
      uint32_t ah[4], al[4];
      warp_mma::split_tf32(a[0], ah[0], al[0]);
      warp_mma::split_tf32(a[8 * T::kAStride], ah[1], al[1]);
      warp_mma::split_tf32(a[4], ah[2], al[2]);
      warp_mma::split_tf32(a[8 * T::kAStride + 4], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) warp_mma::mma_tf32(part[i][j], al, bh[j]);
#pragma unroll
      for (int j = 0; j < NT; ++j) warp_mma::mma_tf32(part[i][j], ah, bl[j]);
#pragma unroll
      for (int j = 0; j < NT; ++j) warp_mma::mma_tf32(part[i][j], ah, bh[j]);
    }
  }
}

// One kind's pass over a CTA's tile: the whole k loop over W[kind, l],
// then the tile's rows of that kind written (their kinds read from shared
// memory after the k loop, not held in registers through it).  A call, not inlined: inlined into the
// loop over the kinds, ptxas keeps values live across the loop's back
// edge, and the 128-row hidden tile needs 255 registers and spills (the
// 64-row one 124 bytes); as a call with its arguments by value, each tile
// compiles as one pass does, with no spill (ptxas -v, chip_smoke phase 2).
template <int WM, int WN, int MT, int NT, bool kLast>
__device__ __noinline__ void layer_pass(const LayerArgs p, float* smem,
                                        const int* s_kind, int kind,
                                        long long row0, int n0) {
  using T = Tile<WM, WN, MT, NT, kLast>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int m_warp = (warp / WN) * 16 * MT, n_warp = (warp % WN) * 8 * NT;
  const float* w = p.w + kind * p.w_kind;
  const float* bias = p.b + kind * p.b_kind;
  float acc[MT][NT][4];  // the layer's sums, in fp32 FADDs
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }

  const Loader<T> load(p, w, row0, n0);
  const int k_tiles = (p.K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load(smem + s * T::kStageFloats, s * kBK);
    warp_mma::cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    warp_mma::cp_async_wait<kStages - 2>();  // tile kt has landed
    __syncthreads();  // for every thread, and stage kt - 1 is free again
    const int next = kt + kStages - 1;
    if (next < k_tiles) {
      load(smem + (next % kStages) * T::kStageFloats, next * kBK);
    }
    warp_mma::cp_async_commit();
    float part[MT][NT][4];  // this k-step's sums, on the tensor cores
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
      }
    }
    mma_stage<T>(smem + (kt % kStages) * T::kStageFloats, m_warp, n_warp, g,
                 t, part);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
      }
    }
  }

  // bit 2 i + h: this thread's row m_warp + 16 i + 8 h + g is of this
  // kind, read from shared memory once, before the stores
  unsigned own = 0u;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m_warp + 16 * i + 8 * h + g;
      if (row0 + r < p.B && s_kind[r] == kind) own |= 1u << (2 * i + h);
    }
  }
  if (kLast) {  // lanes with t = 0 hold column 0 of rows g and g + 8
    if (t == 0) {
      const float b0 = bias[0];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (own >> (2 * i + h) & 1u) {
            p.dst[row0 + m_warp + 16 * i + 8 * h + g] =
                acc[i][0][2 * h] + b0;
          }
        }
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + n_warp + 8 * j + 2 * t;
    if (col >= p.N) continue;  // N is a multiple of 4: col + 1 < N too
    const float2 bb = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (own >> (2 * i + h) & 1u) {
          const long long row = row0 + m_warp + 16 * i + 8 * h + g;
          *reinterpret_cast<float2*>(p.dst + row * p.H + col) =
              make_float2(fmaxf(acc[i][j][2 * h] + bb.x, 0.f),
                          fmaxf(acc[i][j][2 * h + 1] + bb.y, 0.f));
        }
      }
    }
  }
}

template <int WM, int WN, int MT, int NT, bool kLast>
__global__ void __launch_bounds__(32 * WM * WN,
                                  (Tile<WM, WN, MT, NT, kLast>::kMinBlocks))
layer_kernel(const LayerArgs p) {
  using T = Tile<WM, WN, MT, NT, kLast>;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  __shared__ int s_kind[T::BM];                 // each row's kind
  __shared__ unsigned s_bits[T::kThreads / 32];  // each warp's kinds
  const int n_tiles = (p.N + T::BN - 1) / T::BN;
  const int n0 = static_cast<int>(blockIdx.x % n_tiles) * T::BN;
  const long long row0 = static_cast<long long>(blockIdx.x / n_tiles) * T::BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  unsigned bit = 0u;  // this thread's row's kind, as a presence bit
  if (threadIdx.x < T::BM) {
    const long long row = row0 + threadIdx.x;
    int kind = -1;  // rows past B are in no pass
    if (row < p.B) {
      kind = p.kinds == nullptr
                 ? 0
                 : p.kinds[static_cast<int>(row) / p.block_m];
      if (kind >= 0 && kind < p.n_kinds) {
        bit = 1u << kind;
      } else if (kLast) {  // NaN out, never a wild read
        p.dst[row] = __int_as_float(0x7fc00000);
      }
    }
    s_kind[threadIdx.x] = kind;
  }
  bit = __reduce_or_sync(0xffffffffu, bit);
  if (lane == 0) s_bits[warp] = bit;
  __syncthreads();
  unsigned present = 0u;
#pragma unroll
  for (int w = 0; w < T::kThreads / 32; ++w) present |= s_bits[w];
  for (; present != 0u; present &= present - 1u) {
    layer_pass<WM, WN, MT, NT, kLast>(p, smem, s_kind,
                                      __ffs(static_cast<int>(present)) - 1,
                                      row0, n0);
    // no warp may still read the ring when the next pass's prologue
    // refills it
    if (present & (present - 1u)) __syncthreads();
  }
}

// Launch one layer on tile T (passed as a tag).
template <int WM, int WN, int MT, int NT, bool kLast>
cudaError_t launch_layer(Tile<WM, WN, MT, NT, kLast>, const LayerArgs& p,
                         int row_tiles, cudaStream_t stream) {
  using T = Tile<WM, WN, MT, NT, kLast>;
  void (*fn)(const LayerArgs) = layer_kernel<WM, WN, MT, NT, kLast>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(fn,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return err;
  const int n_tiles = (p.N + T::BN - 1) / T::BN;
  fn<<<row_tiles * n_tiles, T::kThreads, T::kSmem, stream>>>(p);
  return cudaGetLastError();
}

// One chain: x (B, H); weights (n_kinds, L, H, H), biases (n_kinds, L, H);
// kinds a kind per block_m rows (block_m 1: a kind a row), or nullptr for
// one MLP (block_m 0); out (B,).
struct Chain {
  const float* x;
  const int* kinds;
  const float* weights;
  const float* biases;
  float* out;
  float* scratch[2];
  int B, H, L, n_kinds, block_m, in_features;
};

template <int BM>
cudaError_t launch_layers(const Chain& c, cudaStream_t stream) {
  const int row_tiles = (c.B + BM - 1) / BM;
  const long long layer_w = static_cast<long long>(c.H) * c.H;
  // layer 0 over in_features rounded up to the MMA depth
  const int k_in = std::min((c.in_features + 7) / 8 * 8, c.H);
  for (int l = 0; l < c.L; ++l) {
    const bool last = l == c.L - 1;
    LayerArgs p;
    p.src = l == 0 ? c.x : c.scratch[(l - 1) % 2];
    p.w = c.weights + l * layer_w;
    p.b = c.biases + static_cast<long long>(l) * c.H;
    p.dst = last ? c.out : c.scratch[l % 2];
    p.kinds = c.kinds;
    p.w_kind = c.L * layer_w;
    p.b_kind = static_cast<long long>(c.L) * c.H;
    p.B = c.B;
    p.H = c.H;
    p.K = l == 0 ? k_in : c.H;
    p.N = last ? std::min(8, c.H) : c.H;
    p.block_m = c.block_m;
    p.n_kinds = c.n_kinds;
    const cudaError_t err =
        last ? launch_layer(typename Tiles<BM>::Last{}, p, row_tiles, stream)
             : launch_layer(typename Tiles<BM>::Hidden{}, p, row_tiles,
                            stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The row tile: the largest of 128, 64, 32 and 16 that still gives the
// hidden layers at least one CTA per SM (at 6,000 rows and H = 256,
// 128-row tiles would give 94 CTAs for 132 SMs, and 64-row tiles 188) and,
// for the block scorer (block_m a multiple of 16), divides block_m, so a
// tile holds one kind and runs one pass.  One MLP (block_m 0) and kinds
// per row (block_m 1) choose by the CTA count alone.
inline int row_tile(const Chain& c) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    sms = 1;
  }
  const long long n_tiles = (c.H + 127) / 128;
  for (int bm = 128; bm > 16; bm /= 2) {
    if ((c.block_m < 16 || c.block_m % bm == 0) &&
        (c.B + bm - 1) / bm * n_tiles >= sms) {
      return bm;
    }
  }
  return 16;
}

inline int launch_chain(const Chain& c, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (row_tile(c)) {
    case 128: return static_cast<int>(launch_layers<128>(c, s));
    case 64: return static_cast<int>(launch_layers<64>(c, s));
    case 32: return static_cast<int>(launch_layers<32>(c, s));
    default: return static_cast<int>(launch_layers<16>(c, s));
  }
}

}  // namespace repro_mlp_tc
