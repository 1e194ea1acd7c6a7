// Causal / windowed GQA flash-attention forward for Hopper (sm_90a), fp32
// FFMA on fp32 or bf16 inputs.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:78
// (flash_attention, body _flash_kernel :31).  Computes, for q (B, H, Sq, D)
// and k, v (B, KV, Skv, D):
//   o[b, h, i] = softmax_j(q_i . k_j * D^-0.5 over allowed j) @ v
// where key j is allowed for query i when j < Skv, j <= i if causal, and
// i - j < window if window > 0.  Query head h reads kv head h / (H / KV):
// K and V are never repeated.  m, l and the accumulator are fp32; the
// output takes the inputs' type.
//
// What bounds it on an H100: at the path's shapes (Qwen3-0.6B prefill, D =
// 128, 16 query heads over 8 kv heads, causal, Sq = Skv up to 4096) the
// work is ~4 * D FLOPs per allowed (i, j) pair and H * 4096^2 / 2 pairs:
// 69 GFLOP against 25 MB of q, k, v and o, far above the bf16 ridge point
// (989 TFLOP/s over 3.35 TB/s = 295 FLOP/B).  So the floor is FLOPs over
// the tensor-core rate.  This first kernel does not reach the tensor
// cores: it is FFMA from shared memory, right first and fast later.
//
// Design.  The TPU kernel walks a sequential kv grid axis with (m, l, acc)
// in VMEM scratch.  Here one CTA of 256 threads owns one (b, h, 64-row q
// tile) and loops over 64-key tiles itself with an online softmax:
//   1. the q tile (fp32, 64 x D) stays in shared memory for the whole loop;
//   2. a key tile is staged, S = Q K^T (each thread a 4 x 4 block of S),
//      masked, written to shared memory;
//   3. the value tile overwrites the key tile while 4 threads per row
//      take the row max and sum (shuffles) and rescale;
//   4. each thread keeps a 4 x (D / 16) block of the output in registers.
// Shared memory is 83 KB at D = 128, so two CTAs share an SM.  Key tiles
// outside the tile's causal / window band are skipped.  Inside the band
// masked scores are the TPU kernel's finite -1e30, never -inf: a row whose
// first tile is fully masked (a window that starts later) adds weight-1
// garbage while its max is still -1e30, and the next tile's correction
// exp(-1e30 - m) = 0 wipes it; with -inf that step would be
// exp(-inf + inf) = NaN.  Rows past Sq and keys past Skv are masked here,
// so the host pads nothing.  q tiles are issued heaviest first (the last
// causal tiles see the most keys).  Inputs and the output are addressed
// through (batch, head, seq) strides with a unit stride on D, so the
// model's (B, S, H, D) activations need no transposing copy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cuda_error.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBKV = 64;       // keys per tile
constexpr int kThreads = 256;  // 16 x 16 thread grid over a 64 x 64 tile
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, h, s;  // elements; the D axis has stride 1
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int D>
constexpr int smem_floats() {
  return kBQ * (D + 4) + kBKV * (D + 1) + kBQ * (kBKV + 4) + 3 * kBQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int H, int KV,
             int Sq, int Skv, Strides sq, Strides sk, Strides sv, Strides so,
             int causal, int window, float scale) {
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

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int qi = q0 + r;
    qs[r * QS + d] = qi < Sq ? load_f(qb + qi * sq.s + d) : 0.f;
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
  const int hi = causal ? min(Skv, q_last + 1) : Skv;
  const int lo = window > 0 ? max(0, q0 - window + 1) / kBKV * kBKV : 0;

  for (int k0 = lo; k0 < hi; k0 += kBKV) {
    __syncthreads();  // q tile and stats written / last tile's P V done
    for (int i = tid; i < kBKV * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const int kj = k0 + c;
      kvs[c * KS + d] = kj < Skv ? load_f(kb + kj * sk.s + d) : 0.f;
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
      const int qpos = q0 + r;
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
      kvs[c * KS + d] = kj < Skv ? load_f(vb + kj * sv.s + d) : 0.f;
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

  T* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qi = q0 + r;
    if (qi >= Sq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) store_f(ob + qi * so.s + tx + 16 * j, acc[i][j] / l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KV, int Sq, int Skv, Strides sq, Strides sk,
           Strides sv, Strides so, int causal, int window, float scale,
           cudaStream_t stream) {
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KV, Sq, Skv, sq, sk,
      sv, so, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               int B, int H, int KV, int Sq, int Skv, Strides sq, Strides sk,
               Strides sv, Strides so, int causal, int window, float scale,
               cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, KV, Sq, Skv, sq, sk, sv, so, causal, window, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, H, KV, Sq, Skv, sq, sk, sv, so, causal, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, KV, Sq, Skv, sq, sk, sv, so, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, KV, Sq, Skv, sq, sk, sv, so, causal, window, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, H, Sq, D), k and v (B, KV, Skv, D), o (B, H, Sq, D), all of one
// type (dtype 0 = fp32, 1 = bf16), addressed by (batch, head, seq) element
// strides with unit stride on D.  D in {16, 32, 64, 128}, H a multiple of
// KV.  Returns a cudaError_t (0 = ok).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int H, int KV, int Sq, int Skv, int D, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, int causal, int window, float scale,
    void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV || Sq <= 0 || Skv <= 0 ||
      B > 65535 || H > 65535 || window < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides sq{q_sb, q_sh, q_ss}, sk{k_sb, k_sh, k_ss},
      sv{v_sb, v_sh, v_ss}, so{o_sb, o_sh, o_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch_d<float>(D, q, k, v, o, B, H, KV, Sq, Skv, sq, sk, sv, so, causal, window, scale, s);
  }
  if (dtype == 1) {
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, H, KV, Sq, Skv, sq, sk, sv, so, causal, window, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
