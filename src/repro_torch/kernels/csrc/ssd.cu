// Mamba2 SSD chunk scan for Hopper (sm_90a), fp32 FFMA on fp32 or bf16
// inputs.
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
// chunk); Q = 1 is the sequential recurrence.  The bound takes the least
// of that over Q (Q of 6-7 at N = 128, P = 64: about 35.5 kFLOP a step,
// where this kernel's Q = 64 does 45.2 k) against about 410 bytes a step
// and head of bf16 x, fp32 dt and y, and b and c (shared by all heads):
// near 90 FLOP/B, above the fp32 ridge point (67 TFLOP/s over 3.35 TB/s
// = 20 FLOP/B), so the floor is FLOPs over the fp32 rate.
//
// Design.  The TPU kernel walks a sequential chunk grid axis with the
// (N, P) state in VMEM scratch.  Here one CTA of 256 threads owns one
// (b, h) and loops over the chunks in order, the state in shared memory:
// the loop takes the place of the sequential grid axis.  Per chunk: stage
// x, b, c (fp32) and dt, take the cumulative decay, build the causal
// (Q, Q) matrix (c_i . b_j) exp(cum_i - cum_j) dt_j only for j <= i (for
// j > i the exponent is positive and could overflow, and inf * 0 is NaN),
// then y, then the state update.  Staged in fp32 a chunk of 128 would need
// 256 KB of shared memory (x 32 + b 64 + c 64 + scores 64 + state 32), over
// the 227 KB a CTA may use, so the chunk is at most 64 (132 KB at N = 128,
// P = 64); the chunk changes only the fp32 rounding.  b and c rows are
// padded to N + 1 floats so 32 consecutive j fall in 32 banks.  Rows past
// L are staged as zeros with dt = 0: they add nothing and decay nothing,
// as the TPU kernel's zero padding, and the host pads nothing.  Inputs are
// addressed by (batch, head, seq) strides, so b and c shared by every head
// (one group) arrive with a head stride of 0 and are never repeated.
// Known limit: a batch-1 prefill gives B * H = 24 CTAs for 132 SMs; a
// chunk-parallel split (states per chunk, then a short scan) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cuda_error.cuh"

namespace {

constexpr int kMaxQ = 64;      // largest chunk the shared-memory plan holds
constexpr int kThreads = 256;

struct Strides {
  long long b, h, l;  // elements; the innermost (P or N) axis has stride 1
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

inline int smem_floats(int P, int N) {
  return kMaxQ * P + 2 * kMaxQ * (N + 1) + kMaxQ * (kMaxQ + 1) + N * P +
         3 * kMaxQ;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a, const T* __restrict__ bmat,
           const T* __restrict__ cmat, float* __restrict__ y,
           float* __restrict__ state_out, int H, int L, int P, int N, int Q,
           Strides sx, Strides sdt, Strides sb, Strides sc, Strides sy) {
  const int NS = N + 1;        // b / c row stride
  const int AS = kMaxQ + 1;    // score row stride
  extern __shared__ float smem[];
  float* xs = smem;                 // kMaxQ x P
  float* bs = xs + kMaxQ * P;       // kMaxQ x NS
  float* cs = bs + kMaxQ * NS;      // kMaxQ x NS
  float* att = cs + kMaxQ * NS;     // kMaxQ x AS
  float* st = att + kMaxQ * AS;     // N x P carried state
  float* dts = st + N * P;          // kMaxQ
  float* cum = dts + kMaxQ;         // kMaxQ
  float* wts = cum + kMaxQ;         // kMaxQ: exp(cum_last - cum_j) dt_j

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const float ah = a[h];
  const T* xb = x + b * sx.b + h * sx.h;
  const float* dtb = dt + b * sdt.b + h * sdt.h;
  const T* bb = bmat + b * sb.b + h * sb.h;
  const T* cb = cmat + b * sc.b + h * sc.h;
  float* yb = y + b * sy.b + h * sy.h;

  for (int i = tid; i < N * P; i += kThreads) st[i] = 0.f;

  for (int l0 = 0; l0 < L; l0 += Q) {
    const int rows = min(Q, L - l0);
    __syncthreads();  // the last chunk's state update is done with xs, bs
    for (int i = tid; i < Q * P; i += kThreads) {
      const int j = i / P, p = i % P;
      xs[j * P + p] = j < rows ? load_f(xb + (l0 + j) * sx.l + p) : 0.f;
    }
    for (int i = tid; i < Q * N; i += kThreads) {
      const int j = i / N, n = i % N;
      const bool in = j < rows;
      bs[j * NS + n] = in ? load_f(bb + (l0 + j) * sb.l + n) : 0.f;
      cs[j * NS + n] = in ? load_f(cb + (l0 + j) * sc.l + n) : 0.f;
    }
    for (int j = tid; j < Q; j += kThreads) {
      dts[j] = j < rows ? dtb[(l0 + j) * sdt.l] : 0.f;
    }
    __syncthreads();
    if (tid == 0) {  // Q <= 64 sequential adds: negligible beside the rest
      float c = 0.f;
      for (int j = 0; j < Q; ++j) {
        c += dts[j] * ah;
        cum[j] = c;
      }
    }
    __syncthreads();
    const float cum_last = cum[Q - 1];

    // att[i][j] = (c_i . b_j) exp(cum_i - cum_j) dt_j for j <= i, else 0
    for (int idx = tid; idx < Q * Q; idx += kThreads) {
      const int i = idx / Q, j = idx % Q;
      float val = 0.f;
      if (j <= i) {
        float dot = 0.f;
        for (int n = 0; n < N; ++n) dot = fmaf(cs[i * NS + n], bs[j * NS + n], dot);
        val = dot * expf(cum[i] - cum[j]) * dts[j];
      }
      att[i * AS + j] = val;
    }
    for (int j = tid; j < Q; j += kThreads) wts[j] = expf(cum_last - cum[j]) * dts[j];
    __syncthreads();

    // y_i = att_i . x  +  exp(cum_i) c_i . S_prev
    for (int idx = tid; idx < rows * P; idx += kThreads) {
      const int i = idx / P, p = idx % P;
      float intra = 0.f;
      for (int j = 0; j <= i; ++j) intra = fmaf(att[i * AS + j], xs[j * P + p], intra);
      float inter = 0.f;
      for (int n = 0; n < N; ++n) inter = fmaf(cs[i * NS + n], st[n * P + p], inter);
      yb[(l0 + i) * sy.l + p] = intra + expf(cum[i]) * inter;
    }
    __syncthreads();  // every y read S_prev

    // S = S_prev exp(cum_last) + sum_j (b_j w_j) x_j^T
    const float decay = expf(cum_last);
    for (int idx = tid; idx < N * P; idx += kThreads) {
      const int n = idx / P, p = idx % P;
      float upd = 0.f;
      for (int j = 0; j < rows; ++j) upd = fmaf(bs[j * NS + n] * wts[j], xs[j * P + p], upd);
      st[idx] = st[idx] * decay + upd;
    }
  }
  __syncthreads();
  float* sb_out = state_out + (static_cast<long long>(b) * H + h) * N * P;
  for (int i = tid; i < N * P; i += kThreads) sb_out[i] = st[i];
}

template <typename T>
int launch(const void* x, const float* dt, const float* a, const void* bmat,
           const void* cmat, float* y, float* state, int B, int H, int L,
           int P, int N, int Q, Strides sx, Strides sdt, Strides sb,
           Strides sc, Strides sy, cudaStream_t stream) {
  const int smem = smem_floats(P, N) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_kernel<T><<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bmat),
      static_cast<const T*>(cmat), y, state, H, L, P, N, Q, sx, sdt, sb, sc,
      sy);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, H, L, P), bmat and cmat (B, H, L, N) of one type (dtype 0 = fp32,
// 1 = bf16); dt (B, H, L) and a (H,) fp32; y (B, H, L, P) fp32, all by
// (batch, head, seq) element strides with unit innermost stride; state
// (B, H, N, P) fp32 contiguous.  1 <= chunk <= 64.  Returns a cudaError_t.
extern "C" int repro_ssd(const void* x, const float* dt, const float* a,
                         const void* bmat, const void* cmat, float* y,
                         float* state, int dtype, int B, int H, int L, int P,
                         int N, int chunk, long long x_sb, long long x_sh,
                         long long x_sl, long long dt_sb, long long dt_sh,
                         long long dt_sl, long long b_sb, long long b_sh,
                         long long b_sl, long long c_sb, long long c_sh,
                         long long c_sl, long long y_sb, long long y_sh,
                         long long y_sl, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || P <= 0 || N <= 0 || chunk <= 0 ||
      chunk > kMaxQ || B > 65535 ||
      smem_floats(P, N) * sizeof(float) > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides sx{x_sb, x_sh, x_sl}, sdt{dt_sb, dt_sh, dt_sl},
      sb{b_sb, b_sh, b_sl}, sc{c_sb, c_sh, c_sl}, sy{y_sb, y_sh, y_sl};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(x, dt, a, bmat, cmat, y, state, B, H, L, P, N, chunk, sx, sdt, sb, sc, sy, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, dt, a, bmat, cmat, y, state, B, H, L, P, N, chunk, sx, sdt, sb, sc, sy, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
