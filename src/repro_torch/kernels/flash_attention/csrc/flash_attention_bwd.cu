// Backward of the prefill attention for Hopper (sm_90a): dq, dk and dv of
// flash_attention.cu's forward. There is no TPU kernel to port here: the
// reference trains through jnp attention (src/repro/models/layers.py:212
// full_attention, :124 blocked_causal_attention) and XLA differentiates it.
// This kernel computes the same gradient for the port's hand-written
// forward, so training on the card runs no plain attention.
//
// What it computes, for q (B, Sq, H, hd), k and v (B, Sk, K, hd), the
// forward's out and dout (same layout as q), GQA with G = H / K, causal
// with q and k positions both from 0 or bidirectional, an optional window
// (qp - kp < window):
//   s = (q * scale) . k with scale = 1 / sqrt(hd), masked scores -1e30,
//   lse_i = m_i + log(max(l_i, 1e-30))  (the forward's m, l and clamp),
//   P = exp(s - lse), D_i = sum_d dout_id * out_id,
//   dv = P^T dout, dS = P * (dout v^T - D), dk = dS^T (q * scale),
//   dq = scale * dS k,
// all in f32 for both dtypes, written once in q's dtype. A row that sees
// no key at all (only possible with Sq > Sk + window) is outside the
// domain: the forward's output there is not a function the models use.
//
// What bounds it on the H100: the five products (q k^T twice, dout v^T,
// P^T dout, dS^T q, dS k) at the training shapes need thousands of FLOPs
// per byte moved, so operations bound it: 2.5x the forward's FLOPs at the
// bf16 tensor-core peak (989 TFLOP/s). This first version is SIMT: exact
// f32 products on the CUDA cores (67 TFLOP/s at most), so it runs well
// below that bound. Tensor cores, TMA and a fused dq pass are later work.
//
// Design: three launches, deterministic (no atomics, each output element
// written by one thread once):
// (a) lse_kernel, one block per (64 query rows, head, batch): recomputes
//     each row's m and l with the forward's SIMT loop (pre-scaled q, the
//     same key tiles, the same masks), writes lse, and D = dout . out.
// (b) dkdv_kernel, one block per (64 key rows, kv head, batch): keeps its
//     K and V tile in shared memory and loops over the G heads of its
//     group and over the query tiles the mask lets see the key tile,
//     accumulating dk and dv in registers; the group's sum is in f32.
// (c) dq_kernel, one block per (64 query rows, head, batch): loops over
//     the key tiles the forward visits and accumulates dq in registers.
// 256 threads; thread (tx, ty) = (t % 16, t / 16) owns the 4 x 4 scores
// at rows ty + 16 i and columns tx + 16 j of a 64 x 64 tile, and the
// output columns tx + 16 c, c < hd / 16, of rows ty + 16 i.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int PS = BK + 1;           // row stride of the P and dS tiles

struct Strides {
  int64_t b, h, s;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

__device__ __forceinline__ bool visible(int qp, int kp, int Sq, int Sk, int causal,
                                        int window) {
  bool ok = qp < Sq && kp < Sk;
  if (causal) ok = ok && kp <= qp;
  if (window > 0) ok = ok && (qp - kp) < window;
  return ok;
}

// rows r0 .. r0 + 63 of a (seq, hd) slice into shared memory [64][ld] as f32
// times mul, zeros past n
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, int64_t ss, int r0,
                                          int n, float mul) {
  for (int i = threadIdx.x; i < 64 * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    const int ri = r0 + r;
    dst[r * ld + d] = ri < n ? to_f32(src[ri * ss + d]) * mul : 0.f;
  }
}

// s[i][j] = Qs[ty + 16 i] . Ks[tx + 16 j] and, with Os/Vs, dp likewise
template <int HD, bool DP>
__device__ __forceinline__ void scores(const float* Qs, int qld, const float* Ks, const float* Os,
                                       int old, const float* Vs, int tx, int ty, float (&s)[4][4],
                                       float (&dp)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qv[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * qld + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    if (DP) {
      float ov[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ov[i] = Os[(ty + 16 * i) * old + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = Vs[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
    }
  }
}

// ----------------------------------------------------------- (a) lse and D

template <int HD>
constexpr size_t lse_smem() {
  return sizeof(float) * (BQ * HD + BK * (HD + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
lse_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ o,
           const T* __restrict__ dout, Strides sq, Strides sk, Strides so, Strides sdo,
           float* __restrict__ lse, float* __restrict__ dsum, int H, int Sq, int Sk, int G,
           float scale, int causal, int window) {
  extern __shared__ float smem[];
  float* Qs = smem;                  // [BQ][HD], pre-scaled as in the forward
  float* Ks = Qs + BQ * HD;          // [BK][HD + 1]
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z, kh = h / G;
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const T* kb = k + b * sk.b + kh * sk.h;
  load_tile<T, HD>(Qs, HD, q + b * sq.b + h * sq.h, sq.s, q0, Sq, scale);

  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  int k_lo = 0, k_hi = Sk;           // the forward's key range for this block
  if (causal) k_hi = min(Sk, q0 + BQ);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();
    load_tile<T, HD>(Ks, HD + 1, kb, sk.s, k0, Sk, 1.f);
    __syncthreads();
    float s[4][4], unused[4][4];
    scores<HD, false>(Qs, HD, Ks, nullptr, 0, nullptr, tx, ty, s, unused);
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
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) rs += expf(s[i][j] - m_new);
      rs = row_sum16(rs);
      l[i] = l[i] * expf(m[i] - m_new) + rs;
      m[i] = m_new;
    }
  }

  const T* ob = o + b * so.b + h * so.h;
  const T* db = dout + b * sdo.b + h * sdo.h;
  const int64_t row0 = ((int64_t)b * H + h) * Sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    float dd = 0.f;
    if (qi < Sq) {
      for (int c = tx; c < HD; c += 16)
        dd = fmaf(to_f32(db[qi * sdo.s + c]), to_f32(ob[qi * so.s + c]), dd);
    }
    dd = row_sum16(dd);
    if (qi < Sq && tx == 0) {
      lse[row0 + qi] = m[i] + logf(fmaxf(l[i], 1e-30f));
      dsum[row0 + qi] = dd;
    }
  }
}

// ------------------------------------------------------------ (b) dk and dv

constexpr int QPAD = 4;              // row stride of the q and dout tiles: HD + QPAD

template <int HD>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (2 * BK * (HD + 1) + 2 * BQ * (HD + QPAD) + 2 * BQ * PS + 2 * BQ);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ dsum, T* __restrict__ dk, T* __restrict__ dv,
            Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv, int H,
            int Sq, int Sk, int G, float scale, int causal, int window) {
  extern __shared__ float smem[];
  constexpr int QL = HD + QPAD;
  float* Ks = smem;                   // [BK][HD + 1]
  float* Vs = Ks + BK * (HD + 1);     // [BK][HD + 1]
  float* Qs = Vs + BK * (HD + 1);     // [BQ][QL], pre-scaled
  float* Os = Qs + BQ * QL;           // [BQ][QL], dout
  float* Ps = Os + BQ * QL;           // [BQ][PS]
  float* Ds = Ps + BQ * PS;           // [BQ][PS], dS
  float* Ls = Ds + BQ * PS;           // [BQ] lse
  float* Dd = Ls + BQ;                // [BQ] D
  constexpr int NC = HD / 16;
  const int k0 = blockIdx.x * BK, kh = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;

  load_tile<T, HD>(Ks, HD + 1, k + b * sk.b + kh * sk.h, sk.s, k0, Sk, 1.f);
  load_tile<T, HD>(Vs, HD + 1, v + b * sv.b + kh * sv.h, sv.s, k0, Sk, 1.f);

  float dK[4][NC], dV[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dK[i][c] = dV[i][c] = 0.f;

  // the query rows that see any key of this tile
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq, k0 + BK - 1 + window) : Sq;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const T* qb = q + b * sq.b + h * sq.h;
    const T* db = dout + b * sdo.b + h * sdo.h;
    const int64_t row0 = ((int64_t)b * H + h) * Sq;
    for (int q0 = (q_lo / BQ) * BQ; q0 < q_hi; q0 += BQ) {
      __syncthreads();               // the previous tile's readers are done
      load_tile<T, HD>(Qs, QL, qb, sq.s, q0, Sq, scale);
      load_tile<T, HD>(Os, QL, db, sdo.s, q0, Sq, 1.f);
      if (t < BQ) {
        const int qi = q0 + t;
        Ls[t] = qi < Sq ? lse[row0 + qi] : 0.f;
        Dd[t] = qi < Sq ? dsum[row0 + qi] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      scores<HD, true>(Qs, QL, Ks, Os, QL, Vs, tx, ty, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const float p =
              visible(q0 + r, k0 + c, Sq, Sk, causal, window) ? expf(s[i][j] - Ls[r]) : 0.f;
          Ps[r * PS + c] = p;
          Ds[r * PS + c] = p * (dp[i][j] - Dd[r]);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int qq = 0; qq < BQ; ++qq) {
        float pv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Ps[qq * PS + ty + 16 * i];
          dsv[i] = Ds[qq * PS + ty + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float ov = Os[qq * QL + tx + 16 * c];
          const float qv = Qs[qq * QL + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dV[i][c] = fmaf(pv[i], ov, dV[i][c]);
            dK[i][c] = fmaf(dsv[i], qv, dK[i][c]);
          }
        }
      }
    }
  }

  T* dkb = dk + b * sdk.b + kh * sdk.h;
  T* dvb = dv + b * sdv.b + kh * sdv.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ki = k0 + ty + 16 * i;
    if (ki < Sk) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        dkb[ki * sdk.s + tx + 16 * c] = from_f32<T>(dK[i][c]);
        dvb[ki * sdv.s + tx + 16 * c] = from_f32<T>(dV[i][c]);
      }
    }
  }
}

// ------------------------------------------------------------------ (c) dq

template <int HD>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * BK * (HD + 1) + 2 * BQ * (HD + QPAD) + BQ * PS + 2 * BQ);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ dsum, T* __restrict__ dq, Strides sq, Strides sk,
          Strides sv, Strides sdo, Strides sdq, int H, int Sq, int Sk, int G, float scale,
          int causal, int window) {
  extern __shared__ float smem[];
  constexpr int QL = HD + QPAD;
  float* Ks = smem;                   // [BK][HD + 1]
  float* Vs = Ks + BK * (HD + 1);     // [BK][HD + 1]
  float* Qs = Vs + BK * (HD + 1);     // [BQ][QL], pre-scaled
  float* Os = Qs + BQ * QL;           // [BQ][QL], dout
  float* Ds = Os + BQ * QL;           // [BQ][PS], dS
  float* Ls = Ds + BQ * PS;           // [BQ]
  float* Dd = Ls + BQ;                // [BQ]
  constexpr int NC = HD / 16;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z, kh = h / G;
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const T* kb = k + b * sk.b + kh * sk.h;
  const T* vb = v + b * sv.b + kh * sv.h;
  const int64_t row0 = ((int64_t)b * H + h) * Sq;

  load_tile<T, HD>(Qs, QL, q + b * sq.b + h * sq.h, sq.s, q0, Sq, scale);
  load_tile<T, HD>(Os, QL, dout + b * sdo.b + h * sdo.h, sdo.s, q0, Sq, 1.f);
  if (t < BQ) {
    const int qi = q0 + t;
    Ls[t] = qi < Sq ? lse[row0 + qi] : 0.f;
    Dd[t] = qi < Sq ? dsum[row0 + qi] : 0.f;
  }

  float dQ[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dQ[i][c] = 0.f;

  int k_lo = 0, k_hi = Sk;
  if (causal) k_hi = min(Sk, q0 + BQ);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();
    load_tile<T, HD>(Ks, HD + 1, kb, sk.s, k0, Sk, 1.f);
    load_tile<T, HD>(Vs, HD + 1, vb, sv.s, k0, Sk, 1.f);
    __syncthreads();
    float s[4][4], dp[4][4];
    scores<HD, true>(Qs, QL, Ks, Os, QL, Vs, tx, ty, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p =
            visible(q0 + r, k0 + c, Sq, Sk, causal, window) ? expf(s[i][j] - Ls[r]) : 0.f;
        Ds[r * PS + c] = p * (dp[i][j] - Dd[r]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = Ds[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kv = Ks[kk * (HD + 1) + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) dQ[i][c] = fmaf(dsv[i], kv, dQ[i][c]);
      }
    }
  }

  T* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi < Sq) {
#pragma unroll
      for (int c = 0; c < NC; ++c) dqb[qi * sdq.s + tx + 16 * c] = from_f32<T>(dQ[i][c] * scale);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  float *lse, *dsum;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int B, H, K, Sq, Sk, causal, window;
  cudaStream_t stream;
};

template <typename T, int HD>
int launch(const Args& a) {
  static const cudaError_t attr = [] {
    cudaError_t e = allow_smem(lse_kernel<T, HD>, lse_smem<HD>());
    if (e == cudaSuccess) e = allow_smem(dkdv_kernel<T, HD>, dkdv_smem<HD>());
    if (e == cudaSuccess) e = allow_smem(dq_kernel<T, HD>, dq_smem<HD>());
    return e;
  }();
  if (attr != cudaSuccess) return (int)attr;
  const int G = a.H / a.K;
  const float scale = 1.0f / sqrtf((float)HD);
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k),
          *v = static_cast<const T*>(a.v), *o = static_cast<const T*>(a.o),
          *dout = static_cast<const T*>(a.dout);
  const dim3 qgrid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  lse_kernel<T, HD><<<qgrid, THREADS, lse_smem<HD>(), a.stream>>>(
      q, k, o, dout, a.sq, a.sk, a.so, a.sdo, a.lse, a.dsum, a.H, a.Sq, a.Sk, G, scale,
      a.causal, a.window);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 kgrid((a.Sk + BK - 1) / BK, a.K, a.B);
  dkdv_kernel<T, HD><<<kgrid, THREADS, dkdv_smem<HD>(), a.stream>>>(
      q, k, v, dout, a.lse, a.dsum, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.sq, a.sk,
      a.sv, a.sdo, a.sdk, a.sdv, a.H, a.Sq, a.Sk, G, scale, a.causal, a.window);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dq_kernel<T, HD><<<qgrid, THREADS, dq_smem<HD>(), a.stream>>>(
      q, k, v, dout, a.lse, a.dsum, static_cast<T*>(a.dq), a.sq, a.sk, a.sv, a.sdo, a.sdq, a.H,
      a.Sq, a.Sk, G, scale, a.causal, a.window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const Args& a) {
  switch (hd) {
    case 16: return launch<T, 16>(a);
    case 32: return launch<T, 32>(a);
    case 64: return launch<T, 64>(a);
    case 128: return launch<T, 128>(a);
    default: return -1;
  }
}

}  // namespace

// q, o, dout, dq: logical (B, H, Sq, hd); k, v, dk, dv: logical
// (B, K, Sk, hd); each given by its (batch, head, seq) element strides,
// head_dim contiguous. lse and dsum: (B, H, Sq) f32 scratch. dtype: 0 =
// float32, 1 = bfloat16. Returns 0, a cudaError_t, or -1 for a dtype,
// head_dim or shape the kernel does not take.
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                   const void* o, const void* dout, void* dq, void* dk,
                                   void* dv, float* lse, float* dsum, int B, int H, int K,
                                   int Sq, int Sk, int hd,
                                   int64_t q_sb, int64_t q_sh, int64_t q_ss,
                                   int64_t k_sb, int64_t k_sh, int64_t k_ss,
                                   int64_t v_sb, int64_t v_sh, int64_t v_ss,
                                   int64_t o_sb, int64_t o_sh, int64_t o_ss,
                                   int64_t do_sb, int64_t do_sh, int64_t do_ss,
                                   int64_t dq_sb, int64_t dq_sh, int64_t dq_ss,
                                   int64_t dk_sb, int64_t dk_sh, int64_t dk_ss,
                                   int64_t dv_sb, int64_t dv_sh, int64_t dv_ss,
                                   int causal, int window, void* stream) {
  if (B <= 0 || H <= 0 || K <= 0 || H % K != 0 || Sq <= 0 || Sk <= 0) return -1;
  const Args a{q, k, v, o, dout, dq, dk, dv, lse, dsum,
               {q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss},
               {o_sb, o_sh, o_ss}, {do_sb, do_sh, do_ss}, {dq_sb, dq_sh, dq_ss},
               {dk_sb, dk_sh, dk_ss}, {dv_sb, dv_sh, dv_ss},
               B, H, K, Sq, Sk, causal, window, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_hd<float>(hd, a);
  if (dtype == 1) return dispatch_hd<__nv_bfloat16>(hd, a);
  return -1;
}
