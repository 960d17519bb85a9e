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
// same way (p = 1 on its -1e30 entries, wiped out by a later alpha = 0).
//
// What bounds it on the H100: at the serve shapes (S = 2048, hd 128 or
// 64) the two products need several hundred FLOPs per byte moved, above
// the 295 FLOP/byte ridge, so the bf16 tensor-core rate (989 TFLOP/s)
// bounds it. The first version of this kernel did its products on the
// f32 CUDA cores (67 TFLOP/s at best, ~21 TFLOP/s measured), widened every
// K/V element to f32 in shared memory and loaded tiles synchronously.
//
// Two bodies, picked from the dtype and head dim alone:
//
// * bf16 with hd 64 or 128 (the served widths): the tensor-core body.
//   One CTA per (128 query rows, q head, batch): two consumer
//   warpgroups of 64 rows each and one producer warp. The query tile is
//   loaded once by TMA; K and V tiles of 128 rows go through a ring of
//   STAGES stages in shared memory. Each stage has a "full" mbarrier for
//   K and one for V (TMA completes each with expect_tx, so S = Q K^T
//   starts before V has landed) and an "empty" mbarrier (each consumer
//   warp arrives when its products have read the stage), so the
//   producer's next loads overlap the warpgroups' work on the current
//   tile. Tiles are 128-byte swizzled in panels of 64 columns.
//   S = Q K^T runs as wgmma m64n128k16 with Q and K both K-major in
//   shared memory; the scores are scaled by log2(e) / sqrt(hd) and
//   masked in f32 (on tiles that no mask touches the scale moves into
//   one fma inside the exponent), the online softmax runs on the
//   accumulator fragment in registers (row max and sum across the 4
//   lanes of a quad), and O += P V runs as wgmma m64n{hd}k16 with P
//   converted to bf16 in registers as the A fragment and V read MN-major
//   (transposed) from shared memory, so neither V nor P is ever
//   transposed or stored. P is rounded to bf16 before P V; the Pallas
//   kernel keeps it in f32.
//   Tensor maps are built on the host over the model's (B, S, H, hd)
//   layout through its strides (dims hd, heads, seq, batch): nothing is
//   copied; rows past the end are zero-filled by TMA and masked. Tiles
//   that the causal mask or the window rule out for every row of the CTA
//   are never loaded, and CTAs of the last (heaviest) query tiles are
//   launched first. cuTensorMapEncodeTiled, a driver API, is reached
//   through cudaGetDriverEntryPoint, so the library links nothing beyond
//   the CUDA runtime.
// * f32 (any head dim) and bf16 at hd 16 or 32: the SIMT body of the
//   first version: exact f32 products on the CUDA cores, which is what
//   meets the 2e-5 f32 tolerance. One block per (64 query rows, q head,
//   batch), 64-row K/V tiles in shared memory, m/l/acc in registers.
//   Each half-warp's 16 lanes own output columns tx + 16 c, c < HD / 16,
//   so at hd 16 (NC = 1) lane tx owns column tx and the 16 lanes still
//   cover every column; the scores' 16 x 64 tile per half-warp does not
//   depend on HD.
//
// Not done yet: warp specialisation with setmaxnreg, ping-pong of the
// softmax of one warpgroup against the other's wgmma, persistent CTAs.
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float NEG_INF = -1e30f;
constexpr float LN2 = 0.6931471805599453f;

// ------------------------------------------------------------------ SIMT body

namespace simt {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;

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

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * HD + BK * (HD + 1) + BK * HD + BQ * BK);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 2)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            T* __restrict__ o, float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
            Strides so, int Sq, int Sk, int G, float scale, int causal, int window) {
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
      if (lse != nullptr && tx == 0)
        lse[((int64_t)b * gridDim.y + h) * Sq + qi] = m[i] + logf(li);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, Strides sq,
           Strides sk, Strides sv, Strides so, int B, int H, int K, int Sq, int Sk, int causal,
           int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  const float scale = 1.0f / sqrtf((float)HD);
  attn_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, sq, sk, sv, so, Sq, Sk, H / K, scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o, float* lse,
                Strides sq, Strides sk, Strides sv, Strides so, int B, int H, int K, int Sq,
                int Sk, int causal, int window, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, sq, sk, sv, so, B, H, K, Sq, Sk, causal, window,
                           stream);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, sq, sk, sv, so, B, H, K, Sq, Sk, causal, window,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, sq, sk, sv, so, B, H, K, Sq, Sk, causal, window,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, sq, sk, sv, so, B, H, K, Sq, Sk, causal, window,
                            stream);
    default:
      return -1;
  }
}

}  // namespace simt

// --------------------------------------------------------- tensor-core body

namespace tc {

constexpr int BM = 128;              // query rows per CTA: two warpgroups of 64
constexpr int BN = 128;              // key rows per K/V tile
constexpr int STAGES = 2;            // K/V ring depth
constexpr int CONSUMERS = 256;       // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp

template <int HD>
struct Smem {
  static constexpr int Q = BM * HD * 2;         // bytes of the query tile
  static constexpr int KV = BN * HD * 2;        // bytes of one K or one V tile
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q;               // stage s at K_OFF + s * 2 * KV
  static constexpr int BAR_OFF = Q + STAGES * 2 * KV;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 3 * STAGES);
  static constexpr int ALLOC = BYTES + 1024;    // room to align the base to 1024
};

// (the accumulator fragment's layout is described at hopper::to_frags).
// LSE: write each row's lse; the serve paths run the instantiation
// without it, whose code is the lse-free kernel's.
template <int HD, bool LSE>
__global__ void __launch_bounds__(THREADS, 1)
attn_tc_kernel(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmk,
               const __grid_constant__ CUtensorMap tmv, __nv_bfloat16* __restrict__ out,
               float* __restrict__ lse, Strides so, int Sq, int Sk, int G, float scale_log2,
               int causal, int window) {
  using L = Smem<HD>;
  constexpr int NP = HD / PANEL;     // panels of a Q/K/V row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;      // swizzle atoms are 1024-aligned
  const uint32_t q_s = base + L::Q_OFF;
  const uint32_t bars = base + L::BAR_OFF;
  const uint32_t q_bar = bars;
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + 2 * STAGES + s); };
  auto k_s = [&](int s) { return base + L::K_OFF + s * 2 * L::KV; };
  auto v_s = [&](int s) { return base + L::K_OFF + s * 2 * L::KV + L::KV; };

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;  // heavy causal tiles first
  const int kh = h / G;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // the kv range any row of this CTA can see, in whole tiles
  int k_lo = 0, k_hi = Sk;
  if (causal) k_hi = min(Sk, q0 + BM);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int first = (k_lo / BN) * BN;
  const int ntiles = k_hi > first ? (k_hi - first + BN - 1) / BN : 0;

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // producer warp: one thread issues every TMA load
    if (lane == 0) {
      mbar_expect_tx(q_bar, L::Q);
#pragma unroll
      for (int p = 0; p < NP; ++p)
        tma_load(q_s + p * BM * 128, &tmq, q_bar, p * PANEL, h, q0, b);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(empty(s), ((j / STAGES) - 1) & 1);
        const int k0 = first + j * BN;
        mbar_expect_tx(k_full(s), L::KV);
#pragma unroll
        for (int p = 0; p < NP; ++p)
          tma_load(k_s(s) + p * BN * 128, &tmk, k_full(s), p * PANEL, kh, k0, b);
        mbar_expect_tx(v_full(s), L::KV);
#pragma unroll
        for (int p = 0; p < NP; ++p)
          tma_load(v_s(s) + p * BN * 128, &tmv, v_full(s), p * PANEL, kh, k0, b);
      }
    }
    return;
  }

  // consumer warpgroup wg owns query rows q0 + 64 * wg .. + 63
  const int wg = warp >> 2;
  const int r0 = 16 * (warp & 3) + (lane >> 2);
  const int qrow[2] = {q0 + 64 * wg + r0, q0 + 64 * wg + r0 + 8};
  const int cq = 2 * (lane & 3);     // this thread's column within each group of 8

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};           // this thread's share of the row sums

  mbar_wait(q_bar, 0);
  __syncwarp();
  const uint32_t q_wg = q_s + wg * 64 * 128;

  for (int j = 0; j < ntiles; ++j) {
    const int s = j % STAGES;
    const int k0 = first + j * BN;
    mbar_wait(k_full(s), (j / STAGES) & 1);
    __syncwarp();                    // wgmma is .aligned: the warp converges first

    // S = Q K^T: K = hd in steps of 16 (32 bytes within a 128-byte panel)
    float sc[BN / 2];
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      const uint64_t da = desc_b128(q_wg + (kk / 4) * BM * 128 + off, 16, 1024);
      const uint64_t db = desc_b128(k_s(s) + (kk / 4) * BN * 128 + off, 16, 1024);
      wgmma_ss_n128(sc, da, db, kk > 0 ? 1 : 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // scale, mask, online softmax on the fragment; m is in scaled units
    const bool edge = (k0 + BN > Sk) || (causal && k0 + BN - 1 > q0) ||
                      (window > 0 && q0 + BM - 1 - k0 >= window);
    float mx[2] = {NEG_INF, NEG_INF};
    if (edge) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int hr = (i >> 1) & 1;
        const int kp = k0 + 8 * (i >> 2) + cq + (i & 1);
        bool ok = kp < Sk;
        if (causal) ok = ok && kp <= qrow[hr];
        if (window > 0) ok = ok && (qrow[hr] - kp) < window;
        sc[i] = ok ? sc[i] * scale_log2 : NEG_INF;
        mx[hr] = fmaxf(mx[hr], sc[i]);
      }
    } else {                         // every score valid: scale inside the exponent
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      mx[0] *= scale_log2;
      mx[1] *= scale_log2;
    }
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      const float m_new = fmaxf(m[hr], mx[hr]);
      alpha[hr] = exp2f(m[hr] - m_new);
      m[hr] = m_new;
    }
    float rs[2] = {0.f, 0.f};
    if (edge) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int hr = (i >> 1) & 1;
        sc[i] = exp2f(sc[i] - m[hr]);
        rs[hr] += sc[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int hr = (i >> 1) & 1;
        sc[i] = fast_exp2(fmaf(sc[i], scale_log2, -m[hr]));
        rs[hr] += sc[i];
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) l[hr] = l[hr] * alpha[hr] + rs[hr];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    // P in bf16 as the register A fragment of each k16 step of O += P V
    uint32_t pa[BN / 16][4];
    to_frags(sc, pa);

    // O += P V: V read MN-major, 16 keys (two 1024-byte swizzle atoms) a
    // step; the hd panels are BN * 128 bytes apart
    mbar_wait(v_full(s), (j / STAGES) & 1);
    __syncwarp();
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t db = desc_b128(v_s(s) + kk * 16 * 128, BN * 128, 1024);
      wgmma_rs<HD>(o, pa[kk], db);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    if (lane == 0) mbar_arrive(empty(s));
  }

  // epilogue: full row sums across the quad, divide, store bf16 pairs;
  // with lse, each row's log-sum-exp in natural units of the scaled
  // scores (m is in base-2 units of scale_log2, converted here once)
  float inv[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float t = l[hr];
    t += __shfl_xor_sync(0xffffffffu, t, 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
    t = fmaxf(t, 1e-30f);
    inv[hr] = 1.f / t;
    if constexpr (LSE) {
      if ((lane & 3) == 0 && qrow[hr] < Sq)
        lse[((int64_t)b * gridDim.x + h) * Sq + qrow[hr]] = m[hr] * LN2 + logf(t);
    }
  }
  __nv_bfloat16* ob = out + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const int hr = (i >> 1) & 1;
    const int row = qrow[hr];
    if (row < Sq) {
      const int col = 8 * (i >> 2) + cq;
      *reinterpret_cast<__nv_bfloat162*>(ob + row * so.s + col) =
          __floats2bfloat162_rn(o[i] * inv[hr], o[i + 1] * inv[hr]);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, Strides sq,
           Strides sk, Strides sv, Strides so, int B, int H, int K, int Sq, int Sk, int causal,
           int window, cudaStream_t stream) {
  constexpr int smem = Smem<HD>::ALLOC;
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(attn_tc_kernel<HD, false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(attn_tc_kernel<HD, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    return e;
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap mq, mk, mv;
  int rc = make_map(&mq, q, B, H, Sq, HD, sq, BM);
  if (rc == 0) rc = make_map(&mk, k, B, K, Sk, HD, sk, BN);
  if (rc == 0) rc = make_map(&mv, v, B, K, Sk, HD, sv, BN);
  if (rc != 0) return rc;
  const dim3 grid(H, B, (Sq + BM - 1) / BM);
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(HD));
  auto kernel = lse != nullptr ? attn_tc_kernel<HD, true> : attn_tc_kernel<HD, false>;
  kernel<<<grid, THREADS, smem, stream>>>(mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, so, Sq,
                                          Sk, H / K, scale_log2, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// q, o: logical (B, H, Sq, hd); k, v: logical (B, K, Sk, hd); each given by
// its (batch, head, seq) element strides, head_dim contiguous. lse: null,
// or (B, H, Sq) f32 contiguous, which then receives each query row's
// log-sum-exp m + log(max(l, 1e-30)) in natural units of the scaled
// scores q . k / sqrt(hd) (both bodies store this unit; the backward
// converts it to its own). With a null lse nothing else changes.
// dtype: 0 = float32, 1 = bfloat16. bf16 at hd 64 or 128 runs the
// tensor-core body, which needs 16-byte aligned base pointers and strides
// (the wrapper checks them); everything else runs the SIMT body. Returns
// 0, a cudaError_t, 2000 + a CUresult when a tensor map cannot be built,
// or -1 for a dtype or head_dim the kernel does not take.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                   void* o, float* lse, int B, int H, int K, int Sq, int Sk,
                                   int hd,
                                   int64_t q_sb, int64_t q_sh, int64_t q_ss,
                                   int64_t k_sb, int64_t k_sh, int64_t k_ss,
                                   int64_t v_sb, int64_t v_sh, int64_t v_ss,
                                   int64_t o_sb, int64_t o_sh, int64_t o_ss,
                                   int causal, int window, void* stream) {
  if (B <= 0 || H <= 0 || K <= 0 || H % K != 0 || Sq <= 0 || Sk <= 0) return -1;
  const Strides sq{q_sb, q_sh, q_ss}, sk{k_sb, k_sh, k_ss}, sv{v_sb, v_sh, v_ss},
      so{o_sb, o_sh, o_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && hd == 128)
    return tc::launch<128>(q, k, v, o, lse, sq, sk, sv, so, B, H, K, Sq, Sk, causal, window, st);
  if (dtype == 1 && hd == 64)
    return tc::launch<64>(q, k, v, o, lse, sq, sk, sv, so, B, H, K, Sq, Sk, causal, window, st);
  if (dtype == 0)
    return simt::dispatch_hd<float>(hd, q, k, v, o, lse, sq, sk, sv, so, B, H, K, Sq, Sk,
                                    causal, window, st);
  if (dtype == 1 && hd == 32)
    return simt::launch<__nv_bfloat16, 32>(q, k, v, o, lse, sq, sk, sv, so, B, H, K, Sq, Sk,
                                           causal, window, st);
  if (dtype == 1 && hd == 16)
    return simt::launch<__nv_bfloat16, 16>(q, k, v, o, lse, sq, sk, sv, so, B, H, K, Sq, Sk,
                                           causal, window, st);
  return -1;
}
