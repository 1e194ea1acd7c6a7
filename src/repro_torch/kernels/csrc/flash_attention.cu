// Causal / windowed GQA flash-attention forward for Hopper (sm_90a): bf16
// on the tensor cores, fp32 on FFMA.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:78
// (flash_attention, body _flash_kernel :31).  Computes, for q (B, H, Sq, D)
// and k, v (B, KV, Skv, D):
//   o[b, h, i] = softmax_j(q_i . k_j * D^-0.5 over allowed j) @ v
// where key j is allowed for query i when j < Skv, j <= i if causal, and
// i - j < window if window > 0, query row r standing at position
// i = q_offset + r and key j at position j (a query chunk of a longer
// sequence against its keys: q_offset 0 is the whole sequence).  Query head h reads kv head h / (H / KV):
// K and V are never repeated.  m, l and the accumulator are fp32; the
// output takes the inputs' type.
//
// What bounds it on an H100: at the path's shapes (Qwen3-0.6B prefill, D =
// 128, 16 query heads over 8 kv heads, causal, Sq = Skv up to 4096) the
// work is ~4 * D FLOPs per allowed (i, j) pair and H * 4096^2 / 2 pairs:
// 69 GFLOP against 25 MB of q, k, v and o, far above the bf16 ridge point
// (989 TFLOP/s over 3.35 TB/s = 295 FLOP/B).  So the floor is FLOPs over
// the tensor-core rate.  The first kernel of the port ran FFMA from shared
// memory for both types: 3.506 ms on that input on an H100 80GB HBM3 at
// 700 W, 2.0% of the bound and 18x slower than PyTorch's SDPA.
//
// The bf16 kernel (the served models' type) is the FA2 structure on
// mma.sync.m16n8k16 (bf16 operands, fp32 sums):
//   * GQA packed into rows: one CTA of 4 warps (8 at D = 256) owns 128
//     rows of one (b, kv head), row t being query position t / rep of
//     query head kv * rep + t % rep (rep = H / KV).  Every query head of
//     the group reads each K/V tile from one load: Qwen3-0.6B's rep 2
//     halves the K/V traffic of a CTA per query head, and any rep works.
//   * Each warp owns 32 rows (two m16 tiles, so every K and V fragment
//     read from shared memory feeds two MMAs; at D = 256 one m16 tile, as
//     TcTiling says why): S = Q K^T for a 64-key tile stays in registers
//     as C fragments; the online softmax runs on them (a row is spread
//     over a quad of lanes); P is rounded to bf16 and regrouped register
//     to register into the A fragments of O += P V
//     (see warp_mma.cuh): P never touches shared memory.  O (the warp's
//     rows x D) stays in registers.  Row sums l add the unrounded fp32 P.
//   * Q, K and V tiles come in by cp.async into padded shared rows (D + 8
//     bf16: ldmatrix without bank conflicts); K and V have separate
//     two-stage rings, so K and V of tile j + 1 load while tile j
//     computes, with one barrier a tile.
//   * Masking only where needed, per warp: a tile that lies wholly inside
//     the warp's causal / window band skips the per-element mask, a tile
//     that none of its rows can see is skipped, and tiles outside the
//     CTA's band are never loaded.  Blocks are issued heaviest q tile
//     first, across all heads.
//   * Scores are scaled to log2 units (exp2 on the special-function
//     unit, ex2.approx).  Masked scores are the TPU
//     kernel's finite -1e30, never -inf: a row whose first tile is fully
//     masked (a window that starts later) adds weight-1 garbage while its
//     max is still -1e30, and the next tile's correction
//     exp(-1e30 - m) = 0 wipes it; with -inf that step would be
//     exp(-inf + inf) = NaN.
// Rows past Sq and keys past Skv are masked (zero-filled copies), so the
// host pads nothing.  Inputs and the output are addressed through (batch,
// head, seq) strides with a unit stride on D, so the model's (B, S, H, D)
// activations need no transposing copy; cp.async wants 16-byte aligned
// rows (the wrapper checks).
//
// The fp32 kernel (inputs of chip_smoke.py's fp32 teacher-forced gate; no
// served model runs fp32) was not redesigned: one CTA of 256 threads owns
// one (b, h, 64-row q tile) and loops over 64-key tiles with an online
// softmax in fp32 FFMA from shared memory (q tile, one K-then-V tile, the
// score tile), 83 KB at D = 128.  A bf16 tensor never reaches it.
#include <climits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cuda_error.cuh"
#include "warp_mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, h, s;  // elements; the D axis has stride 1
};

// ---- fp32: FFMA (the port's first kernel) ------------------------------------
constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBKV = 64;       // keys per tile
constexpr int kThreads = 256;  // 16 x 16 thread grid over a 64 x 64 tile

template <int D>
constexpr int smem_floats() {
  return kBQ * (D + 4) + kBKV * (D + 1) + kBQ * (kBKV + 4) + 3 * kBQ;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int H,
                  int KV, int Sq, int Skv, Strides sq, Strides sk, Strides sv,
                  Strides so, int causal, int window, int q_offset,
                  float scale) {
  constexpr int QS = D + 4;     // q tile row stride: rows 16 apart hit other banks
  constexpr int KS = D + 1;     // k/v tile row stride: 16 keys in 16 banks
  constexpr int SS = kBKV + 4;  // score tile row stride
  constexpr int NJ = D / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;              // kBQ x QS
  float* kvs = qs + kBQ * QS;    // kBKV x KS: K, then V
  float* ss = kvs + kBKV * KS;   // kBQ x SS: scores, then probabilities
  float* m_s = ss + kBQ * SS;    // running max per row
  float* l_s = m_s + kBQ;        // running denominator per row
  float* c_s = l_s + kBQ;        // this tile's correction per row

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + kvh * sk.h;
  const float* vb = v + b * sv.b + kvh * sv.h;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int qi = q0 + r;
    qs[r * QS + d] = qi < Sq ? qb[qi * sq.s + d] : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  // the key tiles any row of this q tile can see
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int hi = causal ? min(Skv, q_offset + q_last + 1) : Skv;
  const int lo =
      window > 0 ? max(0, q_offset + q0 - window + 1) / kBKV * kBKV : 0;

  for (int k0 = lo; k0 < hi; k0 += kBKV) {
    __syncthreads();  // q tile and stats written / last tile's P V done
    for (int i = tid; i < kBKV * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const int kj = k0 + c;
      kvs[c * KS + d] = kj < Skv ? kb[kj * sk.s + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = kvs[(tx + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q_offset + q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kpos = k0 + c;
        bool ok = kpos < Skv;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && qpos - kpos < window;
        ss[r * SS + c] = ok ? s[i][j] * scale : kNegInf;
      }
    }
    __syncthreads();  // scores complete; the key tile is free

    for (int i = tid; i < kBKV * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const int kj = k0 + c;
      kvs[c * KS + d] = kj < Skv ? vb[kj * sv.s + d] : 0.f;
    }
    {  // online softmax: 4 neighbouring lanes per row, columns seg + 4t
      const int r = tid >> 2;
      const int seg = tid & 3;
      float mx = kNegInf;
#pragma unroll
      for (int t = 0; t < kBKV / 4; ++t) mx = fmaxf(mx, ss[r * SS + seg + 4 * t]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < kBKV / 4; ++t) {
        const float p = expf(ss[r * SS + seg + 4 * t] - m_new);
        ss[r * SS + seg + 4 * t] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (seg == 0) {  // every lane of the row read m_prev before the shuffles
        const float corr = expf(m_prev - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
        c_s[r] = corr;
      }
    }
    __syncthreads();  // probabilities, corrections and the value tile ready

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < kBKV; ++c) {
      float p[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ss[(ty + 16 * i) * SS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = kvs[c * KS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();  // l_s final (also when the band held no tile)

  float* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qi = q0 + r;
    if (qi >= Sq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) ob[qi * so.s + tx + 16 * j] = acc[i][j] / l;
  }
}


// ---- bf16: tensor cores ------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int kRowsTC = 128;           // (position, head) rows per CTA
constexpr int kBN = 64;                 // keys per tile

// How a CTA's 128 rows split over its warps.  Up to D = 128 a warp owns
// two 16-row m-tiles (every K and V fragment feeds two MMAs) and a CTA
// has 4 warps, two CTAs an SM.  At D = 256 a warp's 32 x D fp32 O alone
// would take 256 registers a thread, so a warp owns one m-tile (O in 128
// registers) and a CTA has 8 warps; its 198 KB of shared memory (the
// 128-row q tile and two K and two V stages of 64 keys, rows of 264
// bf16) leave room for one CTA an SM.
template <int D>
struct TcTiling {
  static constexpr int kMT = D > 128 ? 1 : 2;  // 16-row m-tiles per warp
  static constexpr int kWarpRows = 16 * kMT;   // rows per warp
  static constexpr int kWarps = kRowsTC / kWarpRows;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kMinBlocks = D > 128 ? 1 : 2;
};

// the q tile and two stages each of K and V, rows padded to D + 8
template <int D>
constexpr int smem_bytes_tc() {
  return (kRowsTC + 4 * kBN) * (D + 8) * static_cast<int>(sizeof(bf16));
}

template <int D>
__global__ void __launch_bounds__(TcTiling<D>::kThreads,
                                  TcTiling<D>::kMinBlocks)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int B,
                  int KV, int rep, int Sq, int Skv, int n_tiles, Strides sq,
                  Strides sk, Strides sv, Strides so, int causal, int window,
                  int q_offset, float scale_log2) {
  using namespace warp_mma;
  constexpr int kMT = TcTiling<D>::kMT;
  constexpr int kWarpRows = TcTiling<D>::kWarpRows;
  constexpr int kThreadsTC = TcTiling<D>::kThreads;
  constexpr int LD = D + 8;   // shared row stride: 8 rows hit 8 bank groups
  constexpr int CH = D / 8;   // 16-byte chunks per row
  constexpr int NT = kBN / 8; // score n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // kRowsTC x LD
  bf16* ks = qs + kRowsTC * LD;                  // 2 x kBN x LD
  bf16* vs = ks + 2 * kBN * LD;                  // 2 x kBN x LD

  const int groups = KV * B;
  const int blk = static_cast<int>(blockIdx.x);
  const int tile = n_tiles - 1 - blk / groups;  // heaviest first
  const int kvh = blk % groups % KV;
  const int b = blk % groups / KV;
  const int total = Sq * rep;                   // rows of this (b, kv)
  const int t0 = tile * kRowsTC;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;

  const bf16* kb = k + b * sk.b + kvh * sk.h;
  const bf16* vb = v + b * sv.b + kvh * sv.h;

  for (int c = tid; c < kRowsTC * CH; c += kThreadsTC) {
    const int r = c / CH, ch = c % CH;
    const int t = t0 + r;
    const bool ok = t < total;
    const int pos = ok ? t / rep : 0;
    const int hh = kvh * rep + (ok ? t % rep : 0);
    cp_async_16(qs + r * LD + ch * 8,
                q + b * sq.b + hh * sq.h + pos * sq.s + ch * 8, ok ? 16 : 0);
  }
  auto load_tile = [&](const bf16* base, long long ss, bf16* dst, int k0) {
    for (int c = tid; c < kBN * CH; c += kThreadsTC) {
      const int r = c / CH, ch = c % CH;
      const bool ok = k0 + r < Skv;
      cp_async_16(dst + r * LD + ch * 8, base + (ok ? k0 + r : 0) * ss + ch * 8,
                  ok ? 16 : 0);
    }
  };

  // the key tiles any row of this CTA can see (positions, not packed rows:
  // the offset goes on t / rep)
  const int p_lo = q_offset + t0 / rep;
  const int p_hi = q_offset + (min(t0 + kRowsTC, total) - 1) / rep;
  const int k_end = causal ? min(Skv, p_hi + 1) : Skv;
  const int k_begin = window > 0 ? max(0, p_lo - window + 1) / kBN * kBN : 0;
  const int n_k = k_end > k_begin ? (k_end - k_begin + kBN - 1) / kBN : 0;

  // this warp's rows; lane rows wr + 16 mt + 8 hf + g, hf = 0, 1
  const int wr = warp * kWarpRows;
  const bool live = t0 + wr < total;
  const int w_lo = q_offset + (t0 + wr) / rep;
  const int w_hi = q_offset + (min(t0 + wr + kWarpRows - 1, total - 1)) / rep;
  int qpos[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      qpos[mt][hf] = q_offset + (t0 + wr + 16 * mt + 8 * hf + g) / rep;

  float acc[kMT][D / 8][4];
  float m[kMT][2], l[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][d][e] = 0.f;
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.f;
  }

  load_tile(kb, sk.s, ks, k_begin);
  load_tile(vb, sv.s, vs, k_begin);
  cp_async_commit();  // group: Q and tile 0

  for (int j = 0; j < n_k; ++j) {
    const int k0 = k_begin + j * kBN;
    const int st = j & 1;
    cp_async_wait<0>();  // tile j, the one group in flight, has landed
    // one barrier a tile: every thread's copies of tile j are visible, and
    // every warp is done with tile j - 1, whose stage tile j + 1 takes
    __syncthreads();
    if (j + 1 < n_k) {
      load_tile(kb, sk.s, ks + (st ^ 1) * kBN * LD, k0 + kBN);
      load_tile(vb, sv.s, vs + (st ^ 1) * kBN * LD, k0 + kBN);
    }
    cp_async_commit();

    // skip a tile none of this warp's rows sees; mask only a tile that
    // some of its rows see in part
    const bool skip = !live || (causal && k0 > w_hi) ||
                      (window > 0 && w_lo - (k0 + kBN - 1) >= window);
    const bool whole = k0 + kBN <= Skv && (!causal || k0 + kBN - 1 <= w_lo) &&
                       (window == 0 || w_hi - k0 < window);
    uint32_t pa[kMT][kBN / 16][4];  // P in bf16, as A fragments of P V
    if (!skip) {
      float s[kMT][NT][4];
      const bf16* kt = ks + st * kBN * LD;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[kMT][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          ldmatrix_x4(a[mt], qs + (wr + 16 * mt + lane % 16) * LD + kk * 16 +
                                 lane / 16 * 8);
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bk[4];
          ldmatrix_x4(bk, kt + (np * 16 + lane % 8 + lane / 16 * 8) * LD +
                              kk * 16 + lane / 8 % 2 * 8);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            mma_bf16(s[mt][2 * np], a[mt], bk[0], bk[1]);
            mma_bf16(s[mt][2 * np + 1], a[mt], bk[2], bk[3]);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float val = s[mt][nt][e] * scale_log2;
            if (!whole) {
              const int kpos = k0 + nt * 8 + 2 * tq + (e & 1);
              const int qp = qpos[mt][e / 2];
              bool ok = kpos < Skv;
              if (causal) ok = ok && kpos <= qp;
              if (window > 0) ok = ok && qp - kpos < window;
              if (!ok) val = kNegInf;
            }
            s[mt][nt][e] = val;
            mx[e / 2] = fmaxf(mx[e / 2], val);
          }
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
          for (int off = 1; off < 4; off *= 2) {
            mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], off));
          }
          const float mn = fmaxf(m[mt][hf], mx[hf]);
          const float corr = fast_exp2(m[mt][hf] - mn);
          m[mt][hf] = mn;
          float sum = 0.f;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int e = 2 * hf; e < 2 * hf + 2; ++e) {
              s[mt][nt][e] = fast_exp2(s[mt][nt][e] - mn);
              sum += s[mt][nt][e];
            }
          }
          // this lane's columns; the quad adds up at the end
          l[mt][hf] = l[mt][hf] * corr + sum;
#pragma unroll
          for (int d = 0; d < D / 8; ++d) {
            acc[mt][d][2 * hf] *= corr;
            acc[mt][d][2 * hf + 1] *= corr;
          }
        }
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk) {  // C fragments regrouped as A
          pa[mt][kk][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
          pa[mt][kk][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
          pa[mt][kk][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
          pa[mt][kk][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
        }
      }
    }

    if (!skip) {
      const bf16* vt = vs + st * kBN * LD;
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vt + (kk * 16 + lane % 16) * LD + dp * 16 +
                                    lane / 16 * 8);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            mma_bf16(acc[mt][2 * dp], pa[mt][kk], bv[0], bv[1]);
            mma_bf16(acc[mt][2 * dp + 1], pa[mt][kk], bv[2], bv[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy may still land in the q rows (n_k = 0)
  __syncthreads();

  // the output goes through this warp's own q rows, for 16-byte stores
  bf16* orow = qs + wr * LD;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float lt = l[mt][hf];
#pragma unroll
      for (int off = 1; off < 4; off *= 2) {
        lt += __shfl_xor_sync(0xffffffffu, lt, off);
      }
      const float inv = 1.f / fmaxf(lt, 1e-30f);
      bf16* row = orow + (16 * mt + 8 * hf + g) * LD + 2 * tq;
#pragma unroll
      for (int d = 0; d < D / 8; ++d) {
        *reinterpret_cast<uint32_t*>(row + d * 8) =
            pack_bf16(acc[mt][d][2 * hf] * inv, acc[mt][d][2 * hf + 1] * inv);
      }
    }
  }
  __syncwarp();
  for (int c = lane; c < kWarpRows * CH; c += 32) {
    const int r = c / CH, ch = c % CH;
    const int t = t0 + wr + r;
    if (t < total) {
      const int pos = t / rep, hh = kvh * rep + t % rep;
      *reinterpret_cast<uint4*>(o + b * so.b + hh * so.h + pos * so.s +
                                ch * 8) =
          *reinterpret_cast<const uint4*>(orow + r * LD + ch * 8);
    }
  }
}

// ---- launchers -----------------------------------------------------------------
template <int D>
int launch_fp32(const void* q, const void* k, const void* v, void* o, int B,
                int H, int KV, int Sq, int Skv, Strides sq, Strides sk,
                Strides sv, Strides so, int causal, int window, int q_offset,
                float scale, cudaStream_t stream) {
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fp32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fp32_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, KV, Sq, Skv,
      sq, sk, sv, so, causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int H, int KV, int Sq, int Skv, Strides sq, Strides sk,
                Strides sv, Strides so, int causal, int window, int q_offset,
                float scale, cudaStream_t stream) {
  const int rep = H / KV;
  const long long rows = static_cast<long long>(Sq) * rep;
  const long long n_tiles = (rows + kRowsTC - 1) / kRowsTC;
  const long long blocks = n_tiles * KV * B;
  if (rows > INT_MAX - kRowsTC || blocks > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = smem_bytes_tc<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bf16_kernel<D><<<static_cast<unsigned>(blocks),
                         TcTiling<D>::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), B, KV, rep, Sq,
      Skv, static_cast<int>(n_tiles), sq, sk, sv, so, causal, window,
      q_offset, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBf16>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               int B, int H, int KV, int Sq, int Skv, Strides sq, Strides sk,
               Strides sv, Strides so, int causal, int window, int q_offset,
               float scale, cudaStream_t stream) {
#define REPRO_FLASH_CASE(d)                                                   \
  case d:                                                                     \
    return kBf16 ? launch_bf16<d>(q, k, v, o, B, H, KV, Sq, Skv, sq, sk, sv,  \
                                  so, causal, window, q_offset, scale,        \
                                  stream)                                     \
                 : launch_fp32<d>(q, k, v, o, B, H, KV, Sq, Skv, sq, sk, sv,  \
                                  so, causal, window, q_offset, scale,        \
                                  stream);
  switch (D) {
    REPRO_FLASH_CASE(16)
    REPRO_FLASH_CASE(32)
    REPRO_FLASH_CASE(64)
    REPRO_FLASH_CASE(80)
    REPRO_FLASH_CASE(128)
    REPRO_FLASH_CASE(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FLASH_CASE
}

bool aligned16(const void* p, const Strides& s) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0 && s.b % 8 == 0 &&
         s.h % 8 == 0 && s.s % 8 == 0;
}

}  // namespace

// q (B, H, Sq, D), k and v (B, KV, Skv, D), o (B, H, Sq, D), all of one
// type (dtype 0 = fp32, 1 = bf16), addressed by (batch, head, seq) element
// strides with unit stride on D; bf16 pointers 16-byte aligned and strides
// multiples of 8.  D in {16, 32, 64, 80, 128, 256}, H a multiple of KV.
// Query row r sits at position q_offset + r (q_offset >= 0), key j at j.
// Returns a cudaError_t (0 = ok).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int H, int KV, int Sq, int Skv, int D, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, int causal, int window, int q_offset,
    float scale, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV || Sq <= 0 || Skv <= 0 ||
      B > 65535 || H > 65535 || window < 0 || q_offset < 0 ||
      q_offset > INT_MAX - Sq) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides sq{q_sb, q_sh, q_ss}, sk{k_sb, k_sh, k_ss},
      sv{v_sb, v_sh, v_ss}, so{o_sb, o_sh, o_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch_d<false>(D, q, k, v, o, B, H, KV, Sq, Skv, sq, sk, sv, so, causal, window, q_offset, scale, s);
  }
  if (dtype == 1) {
    if (!aligned16(q, sq) || !aligned16(k, sk) || !aligned16(v, sv) ||
        !aligned16(o, so)) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
    return dispatch_d<true>(D, q, k, v, o, B, H, KV, Sq, Skv, sq, sk, sv, so, causal, window, q_offset, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
