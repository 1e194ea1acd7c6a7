// Mamba2 SSD chunk scan for Hopper (sm_90a): chunk-parallel in three
// kernels, bf16 products on the tensor cores, fp32 products on FFMA.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd.py:72 (ssd, body
// _ssd_kernel :28).  For x (B, H, L, P), dt (B, H, L), a (H,) negative and
// bmat, cmat (B, H, L, N) it computes the recurrence
//   S_t = S_{t-1} exp(dt_t a) + dt_t b_t x_t^T,   y_t = c_t . S_t
// in the chunked dual form (arXiv:2405.21060): inside a chunk of Q steps,
//   y_i = sum_{j <= i} (c_i . b_j) exp(cum_i - cum_j) dt_j x_j
//         + exp(cum_i) c_i . S_prev,
//   S   = S_prev exp(cum_last) + sum_j exp(cum_last - cum_j) dt_j b_j x_j^T
// with cum the running sum of dt a over the chunk.  y is fp32, as the TPU
// kernel's; the carried state after the last chunk is a second output
// (B, H, N, P), which the TPU kernel discards and Mamba2's decode needs.
//
// What bounds it on an H100: the function's cheapest exact count, not this
// design's.  In chunks of Q the scan costs, per step, 4 N P (readout and
// rank-1 update against the carried state) + (Q+1)(N + P) (the causal
// scores and their product with x) + N P / Q (the state's decay once a
// chunk); Q = 1 is the sequential recurrence.  The least of that over Q
// (Q of 6-7 at N = 128, P = 64: about 35.5 kFLOP a step) against about
// 410 bytes a step and head of bf16 x, fp32 dt and y, and b and c (shared
// by all heads).  chip_smoke.py counts those FLOPs at the rate this kernel
// runs them (bf16 products as two tensor-core products each, see there).
//
// The port's first kernel ran one CTA per (b, h) over the chunks in order:
// 24 CTAs on 132 SMs for a batch-1 Mamba2-130M prefill, FFMA products with
// one thread taking the cumulative sum: 5.662 ms at 1 x 24 x 4096 x 64,
// N 128, on an H100 80GB HBM3 at 700 W.  This design splits the scan at
// the chunk boundaries, as the port's plain models/ssm.py ssd_chunked
// does, over grids that fill the card (1,536 CTAs for stages 1 and 3 at
// that shape):
//   1. chunk states, grid (chunks, H, B): the chunk's cumulative decay (a
//      warp scan), its local state sum_j exp(cum_last - cum_j) dt_j b_j
//      x_j^T (N x P) and cum_last, into scratch the wrapper allocates
//      ((B, H, C, N, P) and (B, H, C) fp32);
//   2. state passing, grid (N P / 256, H, B), each thread one state
//      element along the chunks: S_c = S_{c-1} exp(cum_last_c) + local_c;
//      each slot is overwritten with the state entering its chunk, and the
//      state after the last chunk is the second output;
//   3. output, grid (chunks, H, B): the causal (Q x Q) matrix
//      (c_i . b_j) exp(cum_i - cum_j) dt_j for j <= i (for j > i the
//      exponent is positive and could overflow, and inf * 0 is NaN), then
//      y = att x + exp(cum_i) c S_prev, written once.
// Products: 8 warps each take 16 x 16 output units.  bf16 inputs run
// mma.sync.m16n8k16 with fp32 sums.  Every product of the scan has one
// operand that is an input, exact in bf16 (x, b or c); c b^T takes both as
// they are, and the fp32 operand of (b w)^T x, att x and c S goes in as two
// bf16 terms, hi = bf16(v) and lo = bf16(v - hi), two MMAs into one fp32
// sum: about 2^-16 of relative error per term instead of 2^-8, which keeps
// the fp32 gate.  fp32 inputs run the same kernels with the products on
// FFMA in the same register layout.  Inputs are staged in shared memory
// in their own type by cp.async, all of a CTA's loads in flight at once
// (the carried state too), rows padded so fragment loads hit 32 banks;
// b w is scaled as it is read.  Rows past L are staged as zeros with
// dt = 0 (they add nothing and decay nothing, as the TPU kernel's zero
// padding), so the host pads nothing; N, P and the chunk are padded to 16
// in shared memory.  Inputs are addressed by (batch,
// head, seq) strides, so b and c shared by every head (one group) arrive
// with a head stride of 0 and are never repeated.
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cuda_error.cuh"
#include "warp_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxQ = 64;     // largest chunk: the cumulative sum is 2 a lane
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPassThreads = 256;
constexpr int kPassBatch = 32;  // chunks a state-passing thread loads at once

struct Strides {
  long long b, h, l;  // elements; the innermost (P or N) axis has stride 1
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ uint32_t bits(bf16 v) {
  return *reinterpret_cast<const unsigned short*>(&v);
}

__host__ __device__ __forceinline__ int pad16(int n) {
  return (n + 15) / 16 * 16;
}

// Shared-memory plans, in bytes.  Inputs are staged in their own type T
// (bf16 x, b, c are exact; fp32 stays fp32), the fp32 operands (the
// carried state, att) in fp32.  Row strides keep the fragment loads of 8
// rows on distinct banks: +8 elements where k is contiguous (pairs), and
// where the row index is, +8 in bf16 and +4 in fp32.
template <typename T>
struct Plan {
  static constexpr int kRc = sizeof(T) == 2 ? 8 : 4;  // r-contiguous pad
  int qp, np, pp;
  __host__ __device__ Plan(int Q, int N, int P)
      : qp(pad16(Q)), np(pad16(N)), pp(pad16(P)) {}
  // stage 1: b (Qp x Np, n-contiguous), x (Qp x Pp, p-contiguous)
  __host__ __device__ int b1_ld() const { return np + kRc; }
  __host__ __device__ int x_ld() const { return pp + kRc; }
  __host__ __device__ int state_bytes() const {
    return (qp * b1_ld() + qp * x_ld()) * static_cast<int>(sizeof(T)) +
           3 * qp * 4;
  }
  // stage 3: c and b (Qp x Np, n = k contiguous), x, S (Np x Pp fp32,
  // p-contiguous), att (Qp x Qp fp32, k-contiguous)
  __host__ __device__ int cb_ld() const { return np + 8; }
  __host__ __device__ int s_ld() const { return pp + 4; }
  __host__ __device__ int att_ld() const { return qp + 8; }
  __host__ __device__ int output_bytes() const {
    return (2 * qp * cb_ld() + qp * x_ld()) * static_cast<int>(sizeof(T)) +
           (np * s_ld() + qp * att_ld() + 3 * qp) * 4;
  }
};

// Copies rows [0, Rp) x columns [0, Wp) of an input block (rows x W valid,
// row stride ld, unit column stride) into shared memory of the same type
// at row stride lds, zeros outside the valid block: by cp.async in 16-byte
// pieces where the rows allow it (aligned start, ld and W whole pieces),
// to be waited for with cp_async_wait; else element by element.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int lds,
                                           const T* __restrict__ src,
                                           long long ld, int rows, int W,
                                           int Rp, int Wp, int tid) {
  constexpr int V = 16 / sizeof(T);
  if (reinterpret_cast<unsigned long long>(src) % 16 == 0 && ld % V == 0 &&
      W % V == 0) {
    const int per_row = Wp / V;
    for (int i = tid; i < Rp * per_row; i += kThreads) {
      const int r = i / per_row, c = i % per_row * V;
      const bool in = r < rows && c < W;
      warp_mma::cp_async_16(dst + r * lds + c, in ? src + r * ld + c : src,
                            in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < Rp * Wp; i += kThreads) {
      const int r = i / Wp, c = i % Wp;
      dst[r * lds + c] = r < rows && c < W ? src[r * ld + c] : T(0.f);
    }
  }
}

// Operands of a unit product, element (r, k) with r the row of A or the
// column of B: a matrix in shared memory stored k-contiguous (KC: at
// p[r * ld + k]) or r-contiguous (at p[k * ld + r]).  f2 gives the pair
// (r, k), (r, k + 1) as floats; packed gives it as the bf16 pair of an
// MMA fragment register (bf16 matrices only).
template <typename E, bool KC>
struct Mat {
  const E* p;
  int ld;
  __device__ __forceinline__ float2 f2(int r, int k) const {
    if constexpr (KC && std::is_same<E, float>::value) {
      return *reinterpret_cast<const float2*>(p + r * ld + k);
    }
    if (KC) return make_float2(to_f(p[r * ld + k]), to_f(p[r * ld + k + 1]));
    return make_float2(to_f(p[k * ld + r]), to_f(p[(k + 1) * ld + r]));
  }
  __device__ __forceinline__ uint32_t packed(int r, int k) const {
    if (KC) return *reinterpret_cast<const uint32_t*>(p + r * ld + k);
    return bits(p[k * ld + r]) | bits(p[(k + 1) * ld + r]) << 16;
  }
};

// (b w)^T of stage 1: element (n, j) = b[j][n] w_j, scaled as it is read
template <typename E>
struct ScaledRows {
  const E* p;
  int ld;
  const float* w;
  __device__ __forceinline__ float2 f2(int r, int k) const {
    return make_float2(to_f(p[k * ld + r]) * w[k],
                       to_f(p[(k + 1) * ld + r]) * w[k + 1]);
  }
};

// One warp's 16 x 16 output unit: acc[nt] (this lane's C fragment of
// n-tile nt, warp_mma.cuh) += sum_k A(m0 + row, k) B(k, n0 + 8 nt + col),
// over k < K (a multiple of 16).  SPLIT names the fp32 operand that bf16
// takes as two terms (1: A, 2: B); the other operand is a bf16 input,
// exact, and goes in as it is (both when SPLIT is 0).
template <typename T, int SPLIT, typename OpA, typename OpB>
__device__ __forceinline__ void unit_product(float (&acc)[2][4], OpA A,
                                             OpB B, int m0, int n0, int K,
                                             int lane) {
  using namespace warp_mma;
  const int g = lane / 4, t = lane % 4;
  if constexpr (std::is_same<T, bf16>::value) {
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = m0 + g + (i & 1) * 8, k = k0 + 2 * t + (i / 2) * 8;
        if constexpr (SPLIT == 1) {
          const float2 v = A.f2(r, k);
          split_bf16(v.x, v.y, ah[i], al[i]);
        } else {
          ah[i] = A.packed(r, k);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int n = n0 + 8 * nt + g;
        if constexpr (SPLIT == 2) {
          const float2 b0 = B.f2(n, k0 + 2 * t), b1 = B.f2(n, k0 + 2 * t + 8);
          uint32_t h0, l0, h1, l1;
          split_bf16(b0.x, b0.y, h0, l0);
          split_bf16(b1.x, b1.y, h1, l1);
          mma_bf16(acc[nt], ah, h0, h1);
          mma_bf16(acc[nt], ah, l0, l1);
        } else {
          const uint32_t h0 = B.packed(n, k0 + 2 * t);
          const uint32_t h1 = B.packed(n, k0 + 2 * t + 8);
          mma_bf16(acc[nt], ah, h0, h1);
          if constexpr (SPLIT == 1) mma_bf16(acc[nt], al, h0, h1);
        }
      }
    }
  } else {
    for (int k = 0; k < K; k += 2) {
      const float2 a0 = A.f2(m0 + g, k), a1 = A.f2(m0 + g + 8, k);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const float2 bb = B.f2(n0 + 8 * nt + 2 * t + cc, k);
          acc[nt][cc] = fmaf(a0.y, bb.y, fmaf(a0.x, bb.x, acc[nt][cc]));
          acc[nt][2 + cc] =
              fmaf(a1.y, bb.y, fmaf(a1.x, bb.x, acc[nt][2 + cc]));
        }
      }
    }
  }
}

// Warp 0: cum_j = sum_{i <= j} dt_i a over the (padded) chunk, two steps a
// lane and a shuffle scan; w_j = exp(cum_last - cum_j) dt_j (may be null).
// Returns cum_last to every lane of warp 0.
__device__ __forceinline__ float chunk_cumsum(const float* dts, float ah,
                                              float* cum, float* w, int qp,
                                              int lane) {
  const int j = 2 * lane;
  const float v0 = j < qp ? dts[j] * ah : 0.f;
  const float v1 = j + 1 < qp ? dts[j + 1] * ah : 0.f;
  float s = v0 + v1;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const float o = __shfl_up_sync(0xffffffffu, s, off);
    if (lane >= off) s += o;
  }
  float excl = __shfl_up_sync(0xffffffffu, s, 1);
  if (lane == 0) excl = 0.f;
  const float last = __shfl_sync(0xffffffffu, s, 31);
  if (j < qp) {
    cum[j] = excl + v0;
    if (w) w[j] = expf(last - cum[j]) * dts[j];
  }
  if (j + 1 < qp) {
    cum[j + 1] = s;
    if (w) w[j + 1] = expf(last - s) * dts[j + 1];
  }
  return last;
}

// ---- stage 1: each chunk's local state and total decay ----------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ a,
                       const T* __restrict__ bmat, float* __restrict__ states,
                       float* __restrict__ cum_last, int H, int L, int P,
                       int N, int Q, int C, Strides sx, Strides sdt,
                       Strides sb) {
  const Plan<T> pl(Q, N, P);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* bs = reinterpret_cast<T*>(smem_raw);          // Qp x b1_ld: b
  T* xs = bs + pl.qp * pl.b1_ld();                  // Qp x x_ld: x
  float* dts = reinterpret_cast<float*>(xs + pl.qp * pl.x_ld());  // Qp
  float* cum = dts + pl.qp;                         // Qp
  float* w = cum + pl.qp;                           // Qp

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int l0 = c * Q;
  const int rows = min(Q, L - l0);
  const float* dtb = dt + b * sdt.b + h * sdt.h + l0 * sdt.l;

  stage_rows(bs, pl.b1_ld(), bmat + b * sb.b + h * sb.h + l0 * sb.l, sb.l,
             rows, N, pl.qp, pl.np, tid);
  stage_rows(xs, pl.x_ld(), x + b * sx.b + h * sx.h + l0 * sx.l, sx.l, rows,
             P, pl.qp, pl.pp, tid);
  warp_mma::cp_async_commit();
  for (int j = tid; j < pl.qp; j += kThreads) {
    dts[j] = j < rows ? dtb[j * sdt.l] : 0.f;
  }
  warp_mma::cp_async_wait<0>();
  __syncthreads();
  if (warp == 0) {
    const float last = chunk_cumsum(dts, a[h], cum, w, pl.qp, lane);
    if (lane == 0) cum_last[(static_cast<long long>(b) * H + h) * C + c] = last;
  }
  __syncthreads();

  // local state (Np x Pp) = (b w)^T x
  float* out = states + ((static_cast<long long>(b) * H + h) * C + c) * N * P;
  const int g = lane / 4, t = lane % 4;
  const int units_n = pl.pp / 16;
  for (int u = warp; u < pl.np / 16 * units_n; u += kWarps) {
    const int m0 = u / units_n * 16, n0 = u % units_n * 16;
    float acc[2][4] = {};
    unit_product<T, 1>(acc, ScaledRows<T>{bs, pl.b1_ld(), w},
                       Mat<T, false>{xs, pl.x_ld()}, m0, n0, pl.qp, lane);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = m0 + g + (e >= 2 ? 8 : 0);
        const int p = n0 + 8 * nt + 2 * t + (e & 1);
        if (n < N && p < P) out[n * P + p] = acc[nt][e];
      }
    }
  }
}

// ---- stage 2: pass the state along the chunks ---------------------------------
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass_kernel(float* __restrict__ states,
                      const float* __restrict__ cum_last,
                      float* __restrict__ state_out, int H, int C, int NP) {
  const int i = blockIdx.x * kPassThreads + threadIdx.x;
  if (i >= NP) return;
  const long long bh = static_cast<long long>(blockIdx.z) * H + blockIdx.y;
  float* s = states + bh * C * NP + i;
  const float* cl = cum_last + bh * C;
  float run = 0.f;
  // kPassBatch chunks' loads in flight before their stores (a store to
  // one slot could alias the next load, so the compiler would not reorder)
  for (int c0 = 0; c0 < C; c0 += kPassBatch) {
    float local[kPassBatch], decay[kPassBatch];
#pragma unroll
    for (int u = 0; u < kPassBatch; ++u) {
      const bool in = c0 + u < C;
      local[u] = in ? s[static_cast<long long>(c0 + u) * NP] : 0.f;
      decay[u] = in ? expf(cl[c0 + u]) : 1.f;
    }
#pragma unroll
    for (int u = 0; u < kPassBatch; ++u) {
      if (c0 + u < C) {
        s[static_cast<long long>(c0 + u) * NP] = run;  // state entering it
        run = run * decay[u] + local[u];
      }
    }
  }
  state_out[bh * NP + i] = run;
}

// ---- stage 3: each chunk's output ----------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_output_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ a, const T* __restrict__ bmat,
                  const T* __restrict__ cmat,
                  const float* __restrict__ states, float* __restrict__ y,
                  int H, int L, int P, int N, int Q, int C, Strides sx,
                  Strides sdt, Strides sb, Strides sc, Strides sy) {
  const Plan<T> pl(Q, N, P);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cs = reinterpret_cast<T*>(smem_raw);  // Qp x cb_ld: c, k-contiguous
  T* bs = cs + pl.qp * pl.cb_ld();          // Qp x cb_ld: b, k-contiguous
  T* xs = bs + pl.qp * pl.cb_ld();          // Qp x x_ld: x, p-contiguous
  float* ss = reinterpret_cast<float*>(xs + pl.qp * pl.x_ld());  // S
  float* att = ss + pl.np * pl.s_ld();     // Qp x att_ld
  float* dts = att + pl.qp * pl.att_ld();  // Qp
  float* cum = dts + pl.qp;                // Qp
  float* ecum = cum + pl.qp;               // Qp: exp(cum)

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int l0 = c * Q;
  const int rows = min(Q, L - l0);
  const float* dtb = dt + b * sdt.b + h * sdt.h + l0 * sdt.l;

  // every load in flight at once: c, b, x and the state entering the chunk
  stage_rows(cs, pl.cb_ld(), cmat + b * sc.b + h * sc.h + l0 * sc.l, sc.l,
             rows, N, pl.qp, pl.np, tid);
  stage_rows(bs, pl.cb_ld(), bmat + b * sb.b + h * sb.h + l0 * sb.l, sb.l,
             rows, N, pl.qp, pl.np, tid);
  stage_rows(xs, pl.x_ld(), x + b * sx.b + h * sx.h + l0 * sx.l, sx.l, rows,
             P, pl.qp, pl.pp, tid);
  stage_rows(ss, pl.s_ld(),
             states + ((static_cast<long long>(b) * H + h) * C + c) * N * P,
             P, N, P, pl.np, pl.pp, tid);
  warp_mma::cp_async_commit();
  for (int j = tid; j < pl.qp; j += kThreads) {
    dts[j] = j < rows ? dtb[j * sdt.l] : 0.f;
  }
  warp_mma::cp_async_wait<0>();
  __syncthreads();
  if (warp == 0) chunk_cumsum(dts, a[h], cum, nullptr, pl.qp, lane);
  __syncthreads();
  for (int j = tid; j < pl.qp; j += kThreads) ecum[j] = expf(cum[j]);

  // att = (c b^T) exp(cum_i - cum_j) dt_j for j <= i, else 0
  const int units_q = pl.qp / 16;
  for (int u = warp; u < units_q * units_q; u += kWarps) {
    const int m0 = u / units_q * 16, n0 = u % units_q * 16;
    float acc[2][4] = {};
    unit_product<T, 0>(acc, Mat<T, true>{cs, pl.cb_ld()},
                       Mat<T, true>{bs, pl.cb_ld()}, m0, n0, pl.np, lane);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = m0 + g + (e >= 2 ? 8 : 0);
        const int j = n0 + 8 * nt + 2 * t + (e & 1);
        att[i * pl.att_ld() + j] =
            j <= i ? acc[nt][e] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
      }
    }
  }
  __syncthreads();

  // y = att x + exp(cum_i) c S_prev
  const int units_p = pl.pp / 16;
  float* yb = y + b * sy.b + h * sy.h + l0 * sy.l;
  for (int u = warp; u < units_q * units_p; u += kWarps) {
    const int m0 = u / units_p * 16, n0 = u % units_p * 16;
    float intra[2][4] = {}, inter[2][4] = {};
    unit_product<T, 1>(intra, Mat<float, true>{att, pl.att_ld()},
                       Mat<T, false>{xs, pl.x_ld()}, m0, n0, pl.qp, lane);
    unit_product<T, 2>(inter, Mat<T, true>{cs, pl.cb_ld()},
                       Mat<float, false>{ss, pl.s_ld()}, m0, n0, pl.np,
                       lane);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = m0 + g + (e >= 2 ? 8 : 0);
        const int p = n0 + 8 * nt + 2 * t + (e & 1);
        if (i < rows && p < P) {
          yb[i * sy.l + p] = intra[nt][e] + ecum[i] * inter[nt][e];
        }
      }
    }
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* a, const void* bmat,
           const void* cmat, float* y, float* state, float* states,
           float* cum_last, int B, int H, int L, int P, int N, int Q,
           Strides sx, Strides sdt, Strides sb, Strides sc, Strides sy,
           cudaStream_t stream) {
  const Plan<T> pl(Q, N, P);
  const int C = (L + Q - 1) / Q;
  const int smem1 = pl.state_bytes();
  const int smem3 = pl.output_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_state_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem1);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_output_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem3);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(bmat);
  const dim3 grid(C, H, B);
  ssd_chunk_state_kernel<T><<<grid, kThreads, smem1, stream>>>(
      xt, dt, a, bt, states, cum_last, H, L, P, N, Q, C, sx, sdt, sb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid2((N * P + kPassThreads - 1) / kPassThreads, H, B);
  ssd_state_pass_kernel<<<grid2, kPassThreads, 0, stream>>>(
      states, cum_last, state, H, C, N * P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_output_kernel<T><<<grid, kThreads, smem3, stream>>>(
      xt, dt, a, bt, static_cast<const T*>(cmat), states, y, H, L, P, N, Q,
      C, sx, sdt, sb, sc, sy);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, H, L, P), bmat and cmat (B, H, L, N) of one type (dtype 0 = fp32,
// 1 = bf16); dt (B, H, L) and a (H,) fp32; y (B, H, L, P) fp32, all by
// (batch, head, seq) element strides with unit innermost stride; state
// (B, H, N, P) fp32 contiguous.  Scratch, contiguous fp32: states (B, H,
// C, N, P) and cum_last (B, H, C), C = ceil(L / chunk).  1 <= chunk <= 64.
// Three kernels on the stream.  Returns a cudaError_t.
extern "C" int repro_ssd(const void* x, const float* dt, const float* a,
                         const void* bmat, const void* cmat, float* y,
                         float* state, float* states, float* cum_last,
                         int dtype, int B, int H, int L, int P, int N,
                         int chunk, long long x_sb, long long x_sh,
                         long long x_sl, long long dt_sb, long long dt_sh,
                         long long dt_sl, long long b_sb, long long b_sh,
                         long long b_sl, long long c_sb, long long c_sh,
                         long long c_sl, long long y_sb, long long y_sh,
                         long long y_sl, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || P <= 0 || N <= 0 || chunk <= 0 ||
      chunk > kMaxQ || B > 65535 || H > 65535 ||
      Plan<float>(chunk, N, P).output_bytes() > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides sx{x_sb, x_sh, x_sl}, sdt{dt_sb, dt_sh, dt_sl},
      sb{b_sb, b_sh, b_sl}, sc{c_sb, c_sh, c_sl}, sy{y_sb, y_sh, y_sl};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(x, dt, a, bmat, cmat, y, state, states, cum_last, B, H, L, P, N, chunk, sx, sdt, sb, sc, sy, s);
  }
  if (dtype == 1) {
    return launch<bf16>(x, dt, a, bmat, cmat, y, state, states, cum_last, B, H, L, P, N, chunk, sx, sdt, sb, sc, sy, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
