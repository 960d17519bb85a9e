// Backward of the prefill attention for Hopper (sm_90a): dq, dk and dv of
// flash_attention.cu's forward. There is no TPU kernel to port here: the
// reference trains through jnp attention (src/repro/models/layers.py:212
// full_attention, :124 blocked_causal_attention) and XLA differentiates it.
// This kernel computes the same gradient for the port's hand-written
// forward, so training on the card runs no plain attention.
//
// What it computes, for q (B, Sq, H, hd), k and v (B, Sk, K, hd), the
// forward's out and its row log-sum-exp lse (B, H, Sq), and dout (same
// layout as q), GQA with G = H / K, causal with q and k positions both
// from 0 or bidirectional, an optional window (qp - kp < window):
//   s = q . k * scale with scale = 1 / sqrt(hd), P = exp(s - lse) where
//   the mask lets q see k and 0 elsewhere, D_i = sum_d dout_id * out_id,
//   dv = P^T dout, dS = P * (dout v^T - D), dk = scale dS^T q,
//   dq = scale dS k,
// accumulated in f32, each output element written once in q's dtype. The
// lse comes from the forward (flash_attention_fwd with a non-null lse):
// nothing here recomputes it. A row that sees no key at all (only
// possible with Sq > Sk + window) is outside the domain.
//
// What bounds it on the H100: the five products of the gradient (q k^T,
// dout v^T, P^T dout, dS^T q, dS k) need thousands of FLOPs per byte at
// the training shapes, so operations bound it: 2.5x the forward's FLOPs
// at the bf16 tensor-core peak (989 TFLOP/s).
//
// Three launches on one stream, deterministic (no atomics, each output
// element written by one thread once):
// (a) prep_kernel, one warp per query row: D = dout . out, and the
//     forward's lse in the unit the body uses (natural for the SIMT body,
//     base 2 of the scaled scores for the tensor-core body: converted here
//     once), both into rows padded to a multiple of ROWS_PAD with zeros.
// (b) a dk/dv kernel, one CTA per (key tile, kv head, batch): keeps its K
//     and V tile and loops over the G heads of its group and the query
//     tiles that the mask lets see the key tile; the group's sum is in f32.
// (c) a dq kernel, one CTA per (query tile, head, batch): loops over the
//     key tiles the forward visits. Keeping dq apart costs 7 products
//     instead of the 5 of an atomic dq, and keeps the bits fixed.
//
// Two bodies, picked from the dtype and head dim alone, as the forward's:
//
// * bf16 with hd 64 or 128: the tensor-core body (namespace tc), built
//   from the forward's parts (hopper.cuh): two consumer warpgroups per
//   CTA; tiles are 128-byte swizzled panels loaded by TMA over the
//   model's layout; a ring of stages with full and empty mbarriers
//   overlaps the loads with the products.
//   Each kernel needs more than 200 registers a thread at hd 128, so a
//   CTA is just the two warpgroups (256 threads) and thread 0 issues the
//   TMA loads between its products, a ring's depth ahead: a producer
//   warp would cap every thread at 168 registers (registers go to warps
//   in groups of four, and ptxas did not allocate by setmaxnreg), and
//   the products spill there.
//   dk/dv: 128 key rows per CTA (64 per consumer warpgroup). K and V are
//   loaded once; Q, dout (64-row tiles) and the tile's lse and D (bulk
//   copies) stream through the ring. S^T = K Q^T and dP^T = V dout^T are
//   wgmma m64n64 with both operands K-major in shared memory;
//   P^T = exp2(S^T scale log2(e) - lse2) and dS^T = P^T (dP^T - D) run on
//   the accumulator fragments; dv += P^T dout and dk += dS^T q are wgmma
//   m64n{hd} with P^T and dS^T packed to bf16 as register A fragments and
//   dout and Q read MN-major from the same tiles: nothing is transposed
//   or stored. dk is scaled by 1 / sqrt(hd) at the end.
//   dq: 128 query rows per CTA, Q and dout loaded once, K and V tiles of
//   128 rows streamed; S = Q K^T, dP = dout V^T (shared x shared), dS in
//   registers, dq += dS K with K read MN-major. Heaviest causal tiles are
//   launched first in both kernels; tiles the mask rules out for every row
//   are never loaded; mask arithmetic runs only on tiles that need it.
//   P^T and dS^T are rounded to bf16 before their products (the SIMT body
//   and the plain backward keep them in f32).
// * f32 (any head dim) and bf16 at hd 16 or 32: the SIMT body (namespace
//   simt): exact f32 products on the CUDA cores, which is what meets the
//   f32 1e-4 tolerance. 256 threads, 64 x 64 tiles of f32 in shared
//   memory; thread (tx, ty) = (t % 16, t / 16) owns the 4 x 4 scores at
//   rows ty + 16 i and columns tx + 16 j, and the output columns
//   tx + 16 c, c < hd / 16, of rows ty + 16 i.
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float LOG2E = 1.4426950408889634f;
// the lse and D rows of each (batch, head) are padded to a multiple of
// this many (a 64-row tile's lse is then one aligned 256-byte copy)
constexpr int ROWS_PAD = 64;

__host__ __device__ __forceinline__ int pad_rows(int n) {
  return (n + ROWS_PAD - 1) / ROWS_PAD * ROWS_PAD;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ bool visible(int qp, int kp, int Sq, int Sk, int causal,
                                        int window) {
  bool ok = qp < Sq && kp < Sk;
  if (causal) ok = ok && kp <= qp;
  if (window > 0) ok = ok && (qp - kp) < window;
  return ok;
}

// ----------------------------------------------------------- (a) D pre-pass

constexpr int PREP_THREADS = 256;

// Row r of (B * H, Sq_pad): D = dout . out and lse * lse_mul for r < Sq,
// zeros in the padding.
template <typename T>
__global__ void __launch_bounds__(PREP_THREADS)
prep_kernel(const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
            Strides so, Strides sdo, float* __restrict__ lse_w, float* __restrict__ dsum,
            int rows, int H, int Sq, int Sq_pad, int hd, float lse_mul) {
  const int r = blockIdx.x * (PREP_THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const int bh = r / Sq_pad, i = r % Sq_pad;
  const int b = bh / H, h = bh % H;
  float dd = 0.f;
  if (i < Sq) {
    const T* ob = o + b * so.b + h * so.h + i * so.s;
    const T* db = dout + b * sdo.b + h * sdo.h + i * sdo.s;
    for (int c = lane; c < hd; c += 32) dd = fmaf(to_f32(db[c]), to_f32(ob[c]), dd);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) dd += __shfl_xor_sync(0xffffffffu, dd, off);
  if (lane == 0) {
    lse_w[r] = i < Sq ? lse[(int64_t)bh * Sq + i] * lse_mul : 0.f;
    dsum[r] = dd;
  }
}

// --------------------------------------------------------------- SIMT body

namespace simt {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int PS = BK + 1;           // row stride of the P and dS tiles

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

// ----------------------------------------------------------- SIMT: dk and dv

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
            int Sq, int Sk, int Sq_pad, int G, float scale, int causal, int window) {
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
    const int64_t row0 = ((int64_t)b * H + h) * Sq_pad;
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

// ------------------------------------------------------------------ SIMT: dq

template <int HD>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * BK * (HD + 1) + 2 * BQ * (HD + QPAD) + BQ * PS + 2 * BQ);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ dsum, T* __restrict__ dq, Strides sq, Strides sk,
          Strides sv, Strides sdo, Strides sdq, int H, int Sq, int Sk, int Sq_pad, int G,
          float scale, int causal, int window) {
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
  const int64_t row0 = ((int64_t)b * H + h) * Sq_pad;

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

}  // namespace simt

// ---------------------------------------------------------- tensor-core body

namespace tc {

constexpr int THREADS = 256;         // two warpgroups; thread 0 also issues the loads
constexpr int KV_ROWS = 128;         // dk/dv: key rows per CTA
constexpr int QT_ROWS = 64;          // dk/dv: query rows per streamed tile
constexpr int KV_STAGES = 3;         // dk/dv: Q/dout ring depth
constexpr int DQ_ROWS = 128;         // dq: query rows per CTA
constexpr int KT_ROWS = 128;         // dq: key rows per streamed tile
constexpr int DQ_STAGES = 2;         // dq: K/V ring depth

template <int HD>
struct DkdvSmem {
  static constexpr int KV = KV_ROWS * HD * 2;   // bytes of the K or the V tile
  static constexpr int T = QT_ROWS * HD * 2;    // bytes of one Q or dout tile
  static constexpr int VEC = QT_ROWS * 4;       // bytes of one tile's lse or D
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = KV;
  static constexpr int Q_OFF = 2 * KV;          // stage s: Q at Q_OFF + 2 T s, dout + T
  static constexpr int VEC_OFF = Q_OFF + KV_STAGES * 2 * T;  // stage s: lse + 2 VEC s, D + VEC
  static constexpr int BAR_OFF = VEC_OFF + KV_STAGES * 2 * VEC;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 3 * KV_STAGES);
  static constexpr int ALLOC = BYTES + 1024;    // room to align the base to 1024
};

template <int HD>
struct DqSmem {
  static constexpr int T = DQ_ROWS * HD * 2;    // bytes of the Q or the dout tile
  static constexpr int KV = KT_ROWS * HD * 2;   // bytes of one K or V tile
  static constexpr int Q_OFF = 0;
  static constexpr int DO_OFF = T;
  static constexpr int K_OFF = 2 * T;           // stage s: K at K_OFF + 2 KV s, V + KV
  static constexpr int BAR_OFF = K_OFF + DQ_STAGES * 2 * KV;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 3 * DQ_STAGES);
  static constexpr int ALLOC = BYTES + 1024;
};

// S (64 x N) = A B^T over hd: A 64 rows of a tile of `a_rows` rows, B a
// tile of N rows (64 or 128), both K-major (hd contiguous) in 128-byte
// panels.
template <int HD, int N>
__device__ __forceinline__ void product_ss(float (&d)[N / 2], uint32_t a, int a_rows,
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    const uint64_t da = desc_b128(a + (kk / 4) * a_rows * 128 + off, 16, 1024);
    const uint64_t db = desc_b128(b + (kk / 4) * N * 128 + off, 16, 1024);
    if constexpr (N == 64) wgmma_ss_n64(d, da, db, kk > 0 ? 1 : 0);
    else wgmma_ss_n128(d, da, db, kk > 0 ? 1 : 0);
  }
}

// D (64 x HD) += A (64 x R, register fragments) B, B a tile of R rows x
// HD read MN-major (its rows are the reduction)
template <int HD, int R>
__device__ __forceinline__ void product_rs(float (&d)[HD / 2], const uint32_t (&a)[R / 16][4],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < R / 16; ++kk)
    wgmma_rs<HD>(d, a[kk], desc_b128(b + kk * 16 * 128, R * 128, 1024));
}

// One consumer warpgroup's rows of a 64-row accumulator in bf16 pairs
template <int HD>
__device__ __forceinline__ void store_rows(const float (&acc)[HD / 2], float mul,
                                           __nv_bfloat16* base, int64_t ss, const int (&row)[2],
                                           int n, int cq) {
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const int hr = (i >> 1) & 1;
    if (row[hr] < n) {
      const int col = 8 * (i >> 2) + cq;
      *reinterpret_cast<__nv_bfloat162*>(base + row[hr] * ss + col) =
          __floats2bfloat162_rn(acc[i] * mul, acc[i + 1] * mul);
    }
  }
}

// (b) dk and dv. The accumulator fragments of S^T and dP^T are 64 key
// rows (krow) x 64 query columns: register i is key row krow[(i / 2) % 2]
// and query column 8 (i / 4) + cq + i % 2 of the tile.
// dk and dv take 64 registers each at hd 128 and S^T and dP^T 32 each.
// Thread 0 issues every load: K and V once, the first KV_STAGES query
// tiles, then at the top of iteration j the tile j - 1 + KV_STAGES into
// the stage that tile j - 1 frees, once both warpgroups have arrived on
// its empty barrier.
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmk,
            const __grid_constant__ CUtensorMap tmv, const __grid_constant__ CUtensorMap tmdo,
            const float* __restrict__ lse2, const float* __restrict__ dsum,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, Strides sdk,
            Strides sdv, int H, int Sq, int Sk, int Sq_pad, int G, float scale_log2, float scale,
            int causal, int window) {
  using L = DkdvSmem<HD>;
  constexpr int NP = HD / PANEL;
  constexpr int STAGES = KV_STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const float* vec = reinterpret_cast<const float*>(smem_raw + (base - raw) + L::VEC_OFF);
  const uint32_t vec_s = base + L::VEC_OFF;
  const uint32_t k_s = base + L::K_OFF, v_s = base + L::V_OFF;
  const uint32_t bars = base + L::BAR_OFF;
  const uint32_t kv_bar = bars;
  auto q_full = [&](int s) { return bars + 8u * (1 + s); };
  auto do_full = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + 2 * STAGES + s); };
  auto q_s = [&](int s) { return base + L::Q_OFF + s * 2 * L::T; };
  auto do_s = [&](int s) { return base + L::Q_OFF + s * 2 * L::T + L::T; };

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * KV_ROWS;  // low key tiles see the most causal rows: first
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // the query rows that see any key of this tile, in whole tiles, per head
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq, k0 + KV_ROWS - 1 + window) : Sq;
  const int first = (q_lo / QT_ROWS) * QT_ROWS;
  const int per_head = q_hi > first ? (q_hi - first + QT_ROWS - 1) / QT_ROWS : 0;
  const int ntiles = G * per_head;

  // tile j: head kh G + j / per_head, query rows from q0(j)
  auto q0_of = [&](int j) { return first + (j % per_head) * QT_ROWS; };
  auto issue = [&](int j) {          // Q, dout, lse and D of tile j into its stage
    const int s = j % STAGES;
    const int h = kh * G + j / per_head;
    const int q0 = q0_of(j);
    const int64_t row = ((int64_t)b * H + h) * Sq_pad + q0;
    mbar_expect_tx(q_full(s), L::T + L::VEC);
#pragma unroll
    for (int p = 0; p < NP; ++p)
      tma_load(q_s(s) + p * QT_ROWS * 128, &tmq, q_full(s), p * PANEL, h, q0, b);
    bulk_load(vec_s + s * 2 * L::VEC, lse2 + row, L::VEC, q_full(s));
    mbar_expect_tx(do_full(s), L::T + L::VEC);
#pragma unroll
    for (int p = 0; p < NP; ++p)
      tma_load(do_s(s) + p * QT_ROWS * 128, &tmdo, do_full(s), p * PANEL, h, q0, b);
    bulk_load(vec_s + s * 2 * L::VEC + L::VEC, dsum + row, L::VEC, do_full(s));
  };

  if (tid == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(q_full(s), 1);
      mbar_init(do_full(s), 1);
      mbar_init(empty(s), THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(kv_bar, 2 * L::KV);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      tma_load(k_s + p * KV_ROWS * 128, &tmk, kv_bar, p * PANEL, kh, k0, b);
      tma_load(v_s + p * KV_ROWS * 128, &tmv, kv_bar, p * PANEL, kh, k0, b);
    }
    for (int j = 0; j < min(STAGES, ntiles); ++j) issue(j);
  }
  __syncthreads();

  // consumer warpgroup wg owns key rows k0 + 64 wg .. + 63
  const int wg = warp >> 2;
  const int r0 = 16 * (warp & 3) + (lane >> 2);
  const int krow[2] = {k0 + 64 * wg + r0, k0 + 64 * wg + r0 + 8};
  const int cq = 2 * (lane & 3);
  const uint32_t k_wg = k_s + wg * 64 * 128;
  const uint32_t v_wg = v_s + wg * 64 * 128;

  float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  mbar_wait(kv_bar, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % STAGES;
    const uint32_t ph = (j / STAGES) & 1;
    const int q0 = q0_of(j);
    if (tid == 0 && j >= 1 && j - 1 + STAGES < ntiles) {
      mbar_wait(empty((j - 1) % STAGES), ((j - 1) / STAGES) & 1);
      issue(j - 1 + STAGES);
    }
    const float* lse_t = vec + s * 2 * QT_ROWS;
    const float* d_t = lse_t + QT_ROWS;

    // S^T = K Q^T, then dP^T = V dout^T, one commit group each
    float st[32], dpt[32];
    mbar_wait(q_full(s), ph);
    __syncwarp();                    // wgmma is .aligned: the warp converges first
    fence_regs(st);
    wgmma_fence();
    product_ss<HD, QT_ROWS>(st, k_wg, KV_ROWS, q_s(s));
    wgmma_commit();
    mbar_wait(do_full(s), ph);
    __syncwarp();
    fence_regs(dpt);
    wgmma_fence();
    product_ss<HD, QT_ROWS>(dpt, v_wg, KV_ROWS, do_s(s));
    wgmma_commit();

    // P^T on S^T's fragment while dP^T runs
    wgmma_wait<1>();
    fence_regs(st);
    const bool edge = (q0 + QT_ROWS > Sq) || (k0 + KV_ROWS > Sk) ||
                      (causal && k0 + KV_ROWS - 1 > q0) ||
                      (window > 0 && q0 + QT_ROWS - 1 - k0 >= window);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * (i >> 2) + cq + (i & 1);
      float p = fast_exp2(fmaf(st[i], scale_log2, -lse_t[c]));
      if (edge && !visible(q0 + c, krow[(i >> 1) & 1], Sq, Sk, causal, window)) p = 0.f;
      st[i] = p;
    }
    wgmma_wait<0>();
    fence_regs(dpt);
#pragma unroll
    for (int i = 0; i < 32; ++i) dpt[i] = st[i] * (dpt[i] - d_t[8 * (i >> 2) + cq + (i & 1)]);

    // dv += P^T dout, dk += dS^T Q: bf16 register fragments, the same
    // dout and Q tiles read MN-major
    uint32_t pa[4][4], da[4][4];
    to_frags(st, pa);
    to_frags(dpt, da);
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
    product_rs<HD, QT_ROWS>(dv_acc, pa, do_s(s));
    product_rs<HD, QT_ROWS>(dk_acc, da, q_s(s));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_frags(pa);
    fence_frags(da);
    if (lane == 0) mbar_arrive(empty(s));
  }

  store_rows<HD>(dk_acc, scale, dk + b * sdk.b + kh * sdk.h, sdk.s, krow, Sk, cq);
  store_rows<HD>(dv_acc, 1.f, dv + b * sdv.b + kh * sdv.h, sdv.s, krow, Sk, cq);
}

// (c) dq. The fragments of S and dP are 64 query rows (qrow) x 128 key
// columns: register i is query row qrow[(i / 2) % 2] and key column
// 8 (i / 4) + cq + i % 2 of the tile. S, dP and dq take 64 registers
// each at hd 128. As in (b) thread 0 issues the loads: Q and dout once,
// then the K/V tile j - 1 + DQ_STAGES at the top of iteration j.
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
dq_kernel(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmk,
          const __grid_constant__ CUtensorMap tmv, const __grid_constant__ CUtensorMap tmdo,
          const float* __restrict__ lse2, const float* __restrict__ dsum,
          __nv_bfloat16* __restrict__ dq, Strides sdq, int H, int Sq, int Sk, int Sq_pad, int G,
          float scale_log2, float scale, int causal, int window) {
  using L = DqSmem<HD>;
  constexpr int NP = HD / PANEL;
  constexpr int STAGES = DQ_STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base + L::Q_OFF, do_s = base + L::DO_OFF;
  const uint32_t bars = base + L::BAR_OFF;
  const uint32_t qdo_bar = bars;
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + 2 * STAGES + s); };
  auto k_s = [&](int s) { return base + L::K_OFF + s * 2 * L::KV; };
  auto v_s = [&](int s) { return base + L::K_OFF + s * 2 * L::KV + L::KV; };

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * DQ_ROWS;  // heavy causal tiles first
  const int kh = h / G;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // the forward's kv range for this CTA, in whole tiles
  int k_lo = 0, k_hi = Sk;
  if (causal) k_hi = min(Sk, q0 + DQ_ROWS);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int first = (k_lo / KT_ROWS) * KT_ROWS;
  const int ntiles = k_hi > first ? (k_hi - first + KT_ROWS - 1) / KT_ROWS : 0;

  auto issue = [&](int j) {          // the K and V tiles of iteration j into its stage
    const int s = j % STAGES;
    const int k0 = first + j * KT_ROWS;
    mbar_expect_tx(k_full(s), L::KV);
#pragma unroll
    for (int p = 0; p < NP; ++p)
      tma_load(k_s(s) + p * KT_ROWS * 128, &tmk, k_full(s), p * PANEL, kh, k0, b);
    mbar_expect_tx(v_full(s), L::KV);
#pragma unroll
    for (int p = 0; p < NP; ++p)
      tma_load(v_s(s) + p * KT_ROWS * 128, &tmv, v_full(s), p * PANEL, kh, k0, b);
  };

  if (tid == 0) {
    mbar_init(qdo_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(qdo_bar, 2 * L::T);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      tma_load(q_s + p * DQ_ROWS * 128, &tmq, qdo_bar, p * PANEL, h, q0, b);
      tma_load(do_s + p * DQ_ROWS * 128, &tmdo, qdo_bar, p * PANEL, h, q0, b);
    }
    for (int j = 0; j < min(STAGES, ntiles); ++j) issue(j);
  }
  __syncthreads();

  // consumer warpgroup wg owns query rows q0 + 64 wg .. + 63
  const int wg = warp >> 2;
  const int r0 = 16 * (warp & 3) + (lane >> 2);
  const int qrow[2] = {q0 + 64 * wg + r0, q0 + 64 * wg + r0 + 8};
  const int cq = 2 * (lane & 3);
  const int64_t row0 = ((int64_t)b * H + h) * Sq_pad;
  float l2[2], dd[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l2[hr] = qrow[hr] < Sq ? lse2[row0 + qrow[hr]] : 0.f;
    dd[hr] = qrow[hr] < Sq ? dsum[row0 + qrow[hr]] : 0.f;
  }
  const uint32_t q_wg = q_s + wg * 64 * 128;
  const uint32_t do_wg = do_s + wg * 64 * 128;

  float dq_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq_acc[i] = 0.f;

  mbar_wait(qdo_bar, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % STAGES;
    const uint32_t ph = (j / STAGES) & 1;
    const int k0 = first + j * KT_ROWS;
    if (tid == 0 && j >= 1 && j - 1 + STAGES < ntiles) {
      mbar_wait(empty((j - 1) % STAGES), ((j - 1) / STAGES) & 1);
      issue(j - 1 + STAGES);
    }

    float sc[KT_ROWS / 2], dp[KT_ROWS / 2];
    mbar_wait(k_full(s), ph);
    __syncwarp();
    fence_regs(sc);
    wgmma_fence();
    product_ss<HD, KT_ROWS>(sc, q_wg, DQ_ROWS, k_s(s));
    wgmma_commit();
    mbar_wait(v_full(s), ph);
    __syncwarp();
    fence_regs(dp);
    wgmma_fence();
    product_ss<HD, KT_ROWS>(dp, do_wg, DQ_ROWS, v_s(s));
    wgmma_commit();

    wgmma_wait<1>();
    fence_regs(sc);
    const bool edge = (k0 + KT_ROWS > Sk) || (q0 + DQ_ROWS > Sq) ||
                      (causal && k0 + KT_ROWS - 1 > q0) ||
                      (window > 0 && q0 + DQ_ROWS - 1 - k0 >= window);
#pragma unroll
    for (int i = 0; i < KT_ROWS / 2; ++i) {
      const int hr = (i >> 1) & 1;
      float p = fast_exp2(fmaf(sc[i], scale_log2, -l2[hr]));
      if (edge && !visible(qrow[hr], k0 + 8 * (i >> 2) + cq + (i & 1), Sq, Sk, causal, window))
        p = 0.f;
      sc[i] = p;
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < KT_ROWS / 2; ++i) dp[i] = sc[i] * (dp[i] - dd[(i >> 1) & 1]);

    // dq += dS K: dS in bf16 as register fragments, K read MN-major
    uint32_t da[KT_ROWS / 16][4];
    to_frags(dp, da);
    fence_regs(dq_acc);
    wgmma_fence();
    product_rs<HD, KT_ROWS>(dq_acc, da, k_s(s));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq_acc);
    fence_frags(da);
    if (lane == 0) mbar_arrive(empty(s));
  }

  store_rows<HD>(dq_acc, scale, dq + b * sdq.b + h * sdq.h, sdq.s, qrow, Sq, cq);
}

}  // namespace tc

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  void *dq, *dk, *dv;
  float* work;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int B, H, K, Sq, Sk, hd, causal, window;
  cudaStream_t stream;
  int Sq_pad() const { return pad_rows(Sq); }
  float* lse_w() const { return work; }
  float* dsum() const { return work + (size_t)B * H * pad_rows(Sq); }
};

// (a), for either body: the padded lse rows (times lse_mul) and D
template <typename T>
int launch_prep(const Args& a, float lse_mul) {
  const int rows = a.B * a.H * a.Sq_pad();
  constexpr int per_block = PREP_THREADS / 32;
  prep_kernel<T><<<(rows + per_block - 1) / per_block, PREP_THREADS, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.lse, a.so, a.sdo, a.lse_w(),
      a.dsum(), rows, a.H, a.Sq, a.Sq_pad(), a.hd, lse_mul);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_simt(const Args& a) {
  using namespace simt;
  static const cudaError_t attr = [] {
    cudaError_t e = allow_smem(dkdv_kernel<T, HD>, dkdv_smem<HD>());
    if (e == cudaSuccess) e = allow_smem(dq_kernel<T, HD>, dq_smem<HD>());
    return e;
  }();
  if (attr != cudaSuccess) return (int)attr;
  int e = launch_prep<T>(a, 1.f);
  if (e != 0) return e;
  const int G = a.H / a.K;
  const float scale = 1.0f / sqrtf((float)HD);
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k),
          *v = static_cast<const T*>(a.v), *dout = static_cast<const T*>(a.dout);
  const dim3 kgrid((a.Sk + BK - 1) / BK, a.K, a.B);
  dkdv_kernel<T, HD><<<kgrid, THREADS, dkdv_smem<HD>(), a.stream>>>(
      q, k, v, dout, a.lse_w(), a.dsum(), static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.sq,
      a.sk, a.sv, a.sdo, a.sdk, a.sdv, a.H, a.Sq, a.Sk, a.Sq_pad(), G, scale, a.causal,
      a.window);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  const dim3 qgrid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  dq_kernel<T, HD><<<qgrid, THREADS, dq_smem<HD>(), a.stream>>>(
      q, k, v, dout, a.lse_w(), a.dsum(), static_cast<T*>(a.dq), a.sq, a.sk, a.sv, a.sdo, a.sdq,
      a.H, a.Sq, a.Sk, a.Sq_pad(), G, scale, a.causal, a.window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_simt(const Args& a) {
  switch (a.hd) {
    case 16: return launch_simt<T, 16>(a);
    case 32: return launch_simt<T, 32>(a);
    case 64: return launch_simt<T, 64>(a);
    case 128: return launch_simt<T, 128>(a);
    default: return -1;
  }
}

template <int HD>
int launch_tc(const Args& a) {
  using namespace tc;
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(dkdv_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         DkdvSmem<HD>::ALLOC);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DqSmem<HD>::ALLOC);
    return e;
  }();
  if (attr != cudaSuccess) return (int)attr;
  // tiles of each kernel: (b) 64-row Q / dout, 128-row K / V; (c) the reverse
  CUtensorMap q_b, do_b, k_b, v_b, q_c, do_c, k_c, v_c;
  int rc = make_map(&q_b, a.q, a.B, a.H, a.Sq, HD, a.sq, QT_ROWS);
  if (rc == 0) rc = make_map(&do_b, a.dout, a.B, a.H, a.Sq, HD, a.sdo, QT_ROWS);
  if (rc == 0) rc = make_map(&k_b, a.k, a.B, a.K, a.Sk, HD, a.sk, KV_ROWS);
  if (rc == 0) rc = make_map(&v_b, a.v, a.B, a.K, a.Sk, HD, a.sv, KV_ROWS);
  if (rc == 0) rc = make_map(&q_c, a.q, a.B, a.H, a.Sq, HD, a.sq, DQ_ROWS);
  if (rc == 0) rc = make_map(&do_c, a.dout, a.B, a.H, a.Sq, HD, a.sdo, DQ_ROWS);
  if (rc == 0) rc = make_map(&k_c, a.k, a.B, a.K, a.Sk, HD, a.sk, KT_ROWS);
  if (rc == 0) rc = make_map(&v_c, a.v, a.B, a.K, a.Sk, HD, a.sv, KT_ROWS);
  if (rc != 0) return rc;
  int e = launch_prep<__nv_bfloat16>(a, LOG2E);
  if (e != 0) return e;
  const int G = a.H / a.K;
  const float scale = 1.0f / sqrtf((float)HD);
  const float scale_log2 = LOG2E * scale;
  dkdv_kernel<HD><<<dim3(a.K, a.B, (a.Sk + KV_ROWS - 1) / KV_ROWS), THREADS,
                    DkdvSmem<HD>::ALLOC, a.stream>>>(
      q_b, k_b, v_b, do_b, a.lse_w(), a.dsum(), static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), a.sdk, a.sdv, a.H, a.Sq, a.Sk, a.Sq_pad(), G,
      scale_log2, scale, a.causal, a.window);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  dq_kernel<HD><<<dim3(a.H, a.B, (a.Sq + DQ_ROWS - 1) / DQ_ROWS), THREADS,
                  DqSmem<HD>::ALLOC, a.stream>>>(
      q_c, k_c, v_c, do_c, a.lse_w(), a.dsum(), static_cast<__nv_bfloat16*>(a.dq), a.sdq, a.H,
      a.Sq, a.Sk, a.Sq_pad(), G, scale_log2, scale, a.causal, a.window);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o, dout, dq: logical (B, H, Sq, hd); k, v, dk, dv: logical
// (B, K, Sk, hd); each given by its (batch, head, seq) element strides,
// head_dim contiguous. lse: (B, H, Sq) f32 contiguous, the forward's
// (flash_attention_fwd's lse, natural units of the scaled scores). work:
// f32 scratch of 2 B H pad(Sq) elements, pad(n) = n rounded up to a
// multiple of 64. dtype: 0 = float32, 1 = bfloat16. bf16 at hd 64 or 128
// runs the tensor-core body, which needs 16-byte aligned base pointers and
// strides (the wrapper checks them); everything else runs the SIMT body.
// Returns 0, a cudaError_t, 2000 + a CUresult when a tensor map cannot be
// built, or -1 for a dtype, head_dim or shape the kernel does not take.
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                   const void* o, const void* dout, const float* lse, void* dq,
                                   void* dk, void* dv, float* work, int B, int H, int K,
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
  if (B <= 0 || H <= 0 || K <= 0 || H % K != 0 || Sq <= 0 || Sk <= 0 || lse == nullptr)
    return -1;
  const Args a{q, k, v, o, dout, lse, dq, dk, dv, work,
               {q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss},
               {o_sb, o_sh, o_ss}, {do_sb, do_sh, do_ss}, {dq_sb, dq_sh, dq_ss},
               {dk_sb, dk_sh, dk_ss}, {dv_sb, dv_sh, dv_ss},
               B, H, K, Sq, Sk, hd, causal, window, static_cast<cudaStream_t>(stream)};
  if (dtype == 1 && hd == 128) return launch_tc<128>(a);
  if (dtype == 1 && hd == 64) return launch_tc<64>(a);
  if (dtype == 0) return dispatch_simt<float>(a);
  if (dtype == 1 && (hd == 16 || hd == 32)) return dispatch_simt<__nv_bfloat16>(a);
  return -1;
}
