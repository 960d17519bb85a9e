// Prefill attention for Hopper (sm_90a), the port of the TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention
// (body _attn_kernel, wrapper ops.py::mha, oracle ref.py::attention_ref).
//
// What it computes: out[b, h, i] = softmax_j(q[b, h, i] . k[b, h / G, j]
// / sqrt(hd), masked) @ v[b, h / G, :], GQA with G = H / K, causal with q
// and k positions both from 0 or bidirectional, optional sliding window
// (i - j < window), f32 online softmax, l clamped at 1e-30, output in q's
// dtype. Masked scores are -1e30, not -inf, exactly as in the Pallas
// kernel, so a row that sees no valid key in a visited tile behaves the
// same way.
//
// What bounds it on the H100: at the serve shape (S = 2048, hd = 128) the
// products need ~0.3 kFLOP per byte moved, far above the 295 FLOP/byte
// ridge, so the tensor-core rate bounds it. This first kernel does its
// products on the f32 CUDA cores (one code path for f32 and bf16 inputs,
// exact f32 accumulation), which caps it at the 67 TFLOP/s f32 rate and
// below; wgmma and TMA are the next step.
//
// Design: one block per (64 query rows, q head, batch). The query tile
// stays in shared memory; the block loops over 64-row K/V tiles staged in
// shared memory, with the f32 running max m, sum l and accumulator in
// registers (each of the 256 threads owns 4 rows x hd/16 columns). Tiles
// that the causal mask or the window rules out are never visited, so a
// sliding window costs O(S * W). GQA reads kv head h / G through strides:
// K and V are never copied per q head. Every tensor is addressed through
// its (batch, head, seq) strides, so the model's (B, S, H, hd) layout is
// read without a transpose.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {
  int64_t b, h, s;
};

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * HD + BK * (HD + 1) + BK * HD + BQ * BK);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 2)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            T* __restrict__ o, Strides sq, Strides sk, Strides sv, Strides so,
            int Sq, int Sk, int G, float scale, int causal, int window) {
  extern __shared__ float smem[];
  float* Qs = smem;                  // [BQ][HD], pre-scaled
  float* Ks = Qs + BQ * HD;          // [BK][HD + 1], padded against bank conflicts
  float* Vs = Ks + BK * (HD + 1);    // [BK][HD]
  float* Ps = Vs + BK * HD;          // [BQ][BK], probabilities of this tile

  constexpr int NC = HD / 16;        // output columns per thread
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / G;
  const int t = threadIdx.x;
  const int tx = t & 15;             // column group: lanes 0-15 / 16-31 of a warp
  const int ty = t >> 4;             // row group: rows ty + 16 * i

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + kh * sk.h;
  const T* vb = v + b * sv.b + kh * sv.h;

  for (int i = t; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    const int qi = q0 + r;
    Qs[i] = qi < Sq ? to_f32(qb[qi * sq.s + d]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // the kv range any row of this q block can see
  int k_lo = 0, k_hi = Sk;
  if (causal) k_hi = min(Sk, q0 + BQ);
  if (window > 0) k_lo = max(0, q0 - window + 1);

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();                 // the previous tile's readers are done
    for (int i = t; i < BK * HD; i += THREADS) {
      const int r = i / HD, d = i % HD;
      const int ki = k0 + r;
      const bool in = ki < Sk;       // ragged tail: zeros, masked below
      Ks[r * (HD + 1) + d] = in ? to_f32(kb[ki * sk.s + d]) : 0.f;
      Vs[r * HD + d] = in ? to_f32(vb[ki * sv.s + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * HD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        bool ok = kp < Sk;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && (qp - kp) < window;
        if (!ok) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max16(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * BK + tx + 16 * j] = p;
        rs += p;
      }
      rs = row_sum16(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * BK + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = Vs[kk * HD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

  T* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi < Sq) {
      const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < NC; ++c) ob[qi * so.s + tx + 16 * c] = from_f32<T>(acc[i][c] / li);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, Strides sq, Strides sk,
           Strides sv, Strides so, int B, int H, int K, int Sq, int Sk, int causal,
           int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  const float scale = 1.0f / sqrtf((float)HD);
  attn_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, sk, sv, so, Sq, Sk, H / K, scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o, Strides sq,
                Strides sk, Strides sv, Strides so, int B, int H, int K, int Sq, int Sk,
                int causal, int window, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, sq, sk, sv, so, B, H, K, Sq, Sk, causal, window, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, sq, sk, sv, so, B, H, K, Sq, Sk, causal, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, sq, sk, sv, so, B, H, K, Sq, Sk, causal, window, stream);
    default:
      return -1;
  }
}

}  // namespace

// q, o: logical (B, H, Sq, hd); k, v: logical (B, K, Sk, hd); each given by
// its (batch, head, seq) element strides, head_dim contiguous.
// dtype: 0 = float32, 1 = bfloat16. Returns 0, a cudaError_t, or -1 for a
// dtype or head_dim the kernel does not take.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                   void* o, int B, int H, int K, int Sq, int Sk, int hd,
                                   int64_t q_sb, int64_t q_sh, int64_t q_ss,
                                   int64_t k_sb, int64_t k_sh, int64_t k_ss,
                                   int64_t v_sb, int64_t v_sh, int64_t v_ss,
                                   int64_t o_sb, int64_t o_sh, int64_t o_ss,
                                   int causal, int window, void* stream) {
  if (B <= 0 || H <= 0 || K <= 0 || H % K != 0 || Sq <= 0 || Sk <= 0) return -1;
  const Strides sq{q_sb, q_sh, q_ss}, sk{k_sb, k_sh, k_ss}, sv{v_sb, v_sh, v_ss},
      so{o_sb, o_sh, o_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, o, sq, sk, sv, so, B, H, K, Sq, Sk, causal, window, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, sq, sk, sv, so, B, H, K, Sq, Sk, causal,
                                      window, st);
  return -1;
}
