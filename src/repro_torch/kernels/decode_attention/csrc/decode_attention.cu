// One-token decode attention against a ring KV cache for Hopper (sm_90a),
// the port of the TPU kernel
// src/repro/kernels/decode_attention/kernel.py::flash_decode
// (body _decode_kernel, wrapper ops.py::decode_mha, oracle ref.py::decode_ref).
//
// What it computes: for each (b, q head h) one query token against the
// cache slots of kv head h / G; a slot is valid when slot_pos >= 0 and
// slot_pos <= pos[b] (and pos[b] - slot_pos < window with a window);
// masked scores are -1e30 as in the Pallas kernel; f32 online softmax, l
// clamped at 1e-30, output in q's dtype.
//
// What bounds it on the H100: device memory. Each cache byte is used for
// 2 * G FLOPs, far below the 295 FLOP/byte ridge, so the least time is the
// cache's bytes over 3.35 TB/s. The first version ran one block per (kv
// head, batch): at the serve batch B = 1 that is 8 (llama) or 5 (hymba)
// blocks on 132 SMs, each streaming its whole cache alone, so its time was
// one SM's bandwidth, not the card's.
//
// Design: the W slots of each (kv head, batch) are split across the C
// blocks of one thread-block cluster (grid (C, K, B), cluster (C, 1, 1)).
// C is the largest power of two up to 8, the portable cluster size, that
// keeps at least 128 slots a block and B * K * C blocks within about one
// wave of the SMs: 8 at the serve batch B = 1, so 64 (llama) or 40
// (hymba) blocks instead of 8 or 5. Each block runs eight warps over its
// slot range, each warp taking a step of slots whose loads are in flight
// together, all G q heads of the kv head per block so each cache byte is
// read from device memory once, with an f32 running max, sum and
// accumulator per q head:
//
// * bf16 caches: the products run on the tensor cores (mma.m16n8k16, 16
//   slots a step, P rounded to bf16 before P V; see warp_loop_tc). The
//   first version's SIMT loop spent a five-shuffle warp sum and two
//   exponentials on every (slot, head) pair and was bound by instruction
//   issue, not by memory.
// * f32 caches: the first version's SIMT loop (four slots a step; lane i
//   owns dims i, i + 32, ...; each score a warp-wide sum), exact f32; at
//   hd 16 each half-warp reads its own slot (see warp_loop_simt).
//
// The warps' states are combined in shared memory into one (m, l,
// acc[G][hd]) per block. After a cluster barrier each block combines a
// slice of the outputs from every block's state, read through distributed
// shared memory, with the same exp(m_i - M) rescaling, and a second
// cluster barrier keeps every block resident until all reads are done.
// One launch per call, no global workspace. A split whose slots are all
// invalid has m = -1e30 and weight exp(-1e30 - M) = 0 once any slot is
// valid; with no valid slot at all every weight is 1 and the output is
// the mean of V, as in the plain version (slots past a block's range are
// -inf, so they weigh nothing even then). The cache is read in the
// model's (B, W, K, hd) layout through strides, and slot_pos and pos are
// read on the device: no transposed copy and no host synchronisation.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int NW = 8;                 // warps per block
constexpr int THREADS = NW * 32;
constexpr int U = 4;                  // slots per warp per step
constexpr int MAX_CLUSTER = 8;        // the portable cluster size
constexpr int MIN_SLOTS = 128;        // least slots per block of a cluster
constexpr float NEG_INF = -1e30f;

int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    return count;
  }();
  return n;
}

// The blocks of one cluster: the largest power of two up to 8 that keeps
// at least MIN_SLOTS slots a block and B * K * C blocks within about one
// wave (at most 5/4 of the SMs), down to 1 when the B * K (batch, kv
// head) pairs alone fill a wave. Fewer, longer blocks won at large B.
int cluster_size(int W, int B, int K) {
  const int sms = sm_count();
  int c = MAX_CLUSTER;
  while (c > 1 && (c * MIN_SLOTS > W || (sms > 0 && B * K * c > sms + sms / 4))) c /= 2;
  return c;
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

struct Args {
  const void* q;          // logical (B, H, hd): strides q_sb, q_sh
  const void* k;          // logical (B, W, K, hd): strides c_sb, c_sw, c_sh
  const void* v;
  const int* slot_pos;    // (B, W), row stride sp_sb
  const int* pos;         // (B,)
  void* o;                // logical (B, H, hd): strides o_sb, o_sh
  int64_t q_sb, q_sh, k_sb, k_sw, k_sh, v_sb, v_sw, v_sh, o_sb, o_sh, sp_sb;
  int W, window;
  float scale;
};

// The partial state of every warp of a block, in shared memory: running
// max, sum and (unnormalised) accumulator per q head.
template <int HD, int G>
struct WarpStates {
  float m[NW][G], l[NW][G];
  float acc[NW][G][HD];
};

// f32 caches: the SIMT loop. A slot's row is read by LPS = min(HD, 32)
// lanes, lane i of them owning dims i, i + LPS, ...; each score is a sum
// over those lanes. At hd 32 and up one slot fills the warp; at hd 16 each
// half-warp reads its own slot, so a step reads SPS = 2 slots at once, the
// halves keep separate (m, l, acc) over their slots, and the two states
// are combined with exp(m_i - M) weights at the end, as the warps' are.
template <int HD, int G>
__device__ __forceinline__ void warp_loop_simt(const Args& a, const float* q, const float* kc,
                                               const float* vc, const int* sp, int p, int kh,
                                               int lo, int hi, int warp, int lane,
                                               WarpStates<HD, G>& st) {
  constexpr int LPS = HD < 32 ? HD : 32;   // lanes per slot
  constexpr int SPS = 32 / LPS;            // slots a warp reads at once
  constexpr int PER = HD / LPS;            // dims per lane
  static_assert(LPS * PER == HD && SPS * LPS == 32, "head_dim 16, 32, 64 or 128");
  const int sub = lane / LPS;              // which slot of the SPS this lane reads
  const int dl = lane % LPS;
  float qr[G][PER], m[G], l[G], acc[G][PER];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      qr[g][j] = q[(kh * G + g) * a.q_sh + dl + LPS * j] * a.scale;
      acc[g][j] = 0.f;
    }
  }

  for (int w0 = lo + warp * U * SPS; w0 < hi; w0 += NW * U * SPS) {
    float kv[U][PER], vv[U][PER];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int w = w0 + u * SPS + sub;
      const bool in = w < hi;
      const int s = in ? sp[w] : -1;
      ok[u] = in && s >= 0 && s <= p && (a.window <= 0 || p - s < a.window);
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        kv[u][j] = in ? kc[w * a.k_sw + dl + LPS * j] : 0.f;
        vv[u][j] = in ? vc[w * a.v_sw + dl + LPS * j] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (w0 + u * SPS >= hi) break;  // warp-uniform: no slot of this step is in range
      const bool in = w0 + u * SPS + sub < hi;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < PER; ++j) s = fmaf(qr[g][j], kv[u][j], s);
#pragma unroll
        for (int off = LPS / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (!in) continue;            // past the range: this half-warp's slot weighs nothing
        if (!ok[u]) s = NEG_INF;
        const float m_new = fmaxf(m[g], s);
        const float alpha = expf(m[g] - m_new);
        const float pw = expf(s - m_new);
        l[g] = l[g] * alpha + pw;
#pragma unroll
        for (int j = 0; j < PER; ++j) acc[g][j] = fmaf(pw, vv[u][j], acc[g][j] * alpha);
        m[g] = m_new;
      }
    }
  }

  if constexpr (SPS > 1) {
    // the half-warps' states combined, as the warps' are in decode_kernel
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], LPS);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[g], LPS);
      const float M = fmaxf(m[g], mo);
      const float e = expf(m[g] - M), eo = expf(mo - M);
      l[g] = fmaf(l[g], e, l_o * eo);
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][j], LPS);
        acc[g][j] = fmaf(acc[g][j], e, ao * eo);
      }
      m[g] = M;
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      st.m[warp][g] = m[g];
      st.l[warp][g] = l[g];
    }
    if (sub == 0) {
#pragma unroll
      for (int j = 0; j < PER; ++j) st.acc[warp][g][dl + LPS * j] = acc[g][j];
    }
  }
}

// D (16 x 8, f32) += A (16 x 16, bf16) * B (16 x 8, bf16).
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// N 32-bit words (N / 2 bf16 pairs) from 16-byte aligned memory (8-byte
// aligned when N == 2, 4-byte when N == 1).
template <int N>
__device__ __forceinline__ void load_words(uint32_t (&w)[N], const __nv_bfloat16* src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(src) + i);
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
  } else if constexpr (N == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
    w[0] = v.x;
    w[1] = v.y;
  } else {
    static_assert(N == 1, "one word, two words or a multiple of four");
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(src));
  }
}

// bf16 caches: the products on the tensor cores (mma.m16n8k16). A warp
// takes 16 slots a step, their loads in flight together. S = Q K^T has
// the q heads as rows (padded to 16) and two n-tiles of 8 slots; thread
// (r = lane / 4, t = lane % 4) holds head r's scores of slots 2t, 2t + 1
// and 8 + 2t, 9 + 2t, which is exactly the B fragment of O^T += V^T P^T
// (P rounded to bf16), whose rows are hd and whose 8 columns are the
// heads, so no accumulator row is wasted. Both products sum over an
// index that may be permuted at will, so each thread loads contiguous
// pieces of a row, HD / 2 bytes of K and HD / 4 of V (16-byte vectors at
// hd 64 and 128; at hd 32 8 bytes of V, at hd 16 8 bytes of K and 4 of V,
// one k-step and one m-tile): for S, pair e of k-step kk is
// hd HD / 4 * t + 4 kk + 2 e; for O, row i (< 16) of m-tile j is
// hd HD / 8 * (i % 8) + 2 j + i / 8.
template <int HD, int G>
__device__ __forceinline__ void warp_loop_tc(const Args& a, const __nv_bfloat16* q,
                                             const __nv_bfloat16* kc, const __nv_bfloat16* vc,
                                             const int* sp, int p, int kh, int lo, int hi,
                                             int warp, int lane, WarpStates<HD, G>& st) {
  constexpr int KW = HD / 8;          // words of K per thread and slot (HD / 4 values)
  constexpr int VW = HD / 16;         // words of V per thread and slot (HD / 8 values)
  constexpr int KS = HD / 16;         // k-steps of S = Q K^T
  constexpr int MT = HD / 16;         // m-tiles of O^T
  const int r = lane >> 2, t = lane & 3;
  const float scale_log2 = a.scale * 1.4426950408889634f;

  // Q as the A fragment: head r's values at hd HD / 4 * t + 2 i, + 1
  uint32_t qa[KW];
#pragma unroll
  for (int i = 0; i < KW; ++i) {
    if (r < G) {
      const __nv_bfloat16* qh = q + (kh * G + r) * a.q_sh + HD / 4 * t + 2 * i;
      __nv_bfloat162 v;
      v.x = qh[0];
      v.y = qh[1];
      qa[i] = *reinterpret_cast<uint32_t*>(&v);
    } else {
      qa[i] = 0u;
    }
  }

  float o[MT][4];                     // O^T: hd rows, heads 2t and 2t + 1
#pragma unroll
  for (int j = 0; j < MT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m = NEG_INF, l = 0.f;         // head r's state; l is this thread's share

  for (int w0 = lo + warp * 16; w0 < hi; w0 += NW * 16) {
    // K rows of slots w0 + r and w0 + 8 + r; V rows and slot_pos of the
    // slots of this thread's scores, w0 + 8 (e / 2) + 2t + e % 2
    uint32_t kw[2][KW], vw[4][VW];
    int spv[4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int w = w0 + 8 * j + r;
      if (w < hi) {
        load_words(kw[j], kc + w * a.k_sw + HD / 4 * t);
      } else {
#pragma unroll
        for (int i = 0; i < KW; ++i) kw[j][i] = 0u;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int w = w0 + 8 * (e >> 1) + 2 * t + (e & 1);
      if (w < hi) {
        load_words(vw[e], vc + w * a.v_sw + HD / 8 * r);
        spv[e] = sp[w];
      } else {
#pragma unroll
        for (int i = 0; i < VW; ++i) vw[e][i] = 0u;
        spv[e] = -1;
      }
    }

    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        mma_bf16(s[j], qa[2 * kk], 0u, qa[2 * kk + 1], 0u, kw[j][2 * kk], kw[j][2 * kk + 1]);
    }

    // scale, mask (-1e30 for an invalid slot, -inf past this block's
    // range, which must weigh nothing), online softmax of head r
    float x[4], mx = NEG_INF;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int w = w0 + 8 * (e >> 1) + 2 * t + (e & 1);
      const int sv = spv[e];
      const bool ok = sv >= 0 && sv <= p && (a.window <= 0 || p - sv < a.window);
      x[e] = w >= hi ? -__int_as_float(0x7f800000) : (ok ? s[e >> 1][e & 1] * scale_log2 : NEG_INF);
      mx = fmaxf(mx, x[e]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = exp2f(m - m_new);
    m = m_new;
    float pe[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) pe[e] = exp2f(x[e] - m);
    l = l * alpha + (pe[0] + pe[1] + pe[2] + pe[3]);

    // O^T = O^T * alpha + V^T P^T; this thread's columns are heads 2t and
    // 2t + 1, whose alpha lives on lanes 8t and 8t + 4
    const float alpha0 = __shfl_sync(0xffffffffu, alpha, 8 * t);
    const float alpha1 = __shfl_sync(0xffffffffu, alpha, 8 * t + 4);
    const uint32_t b0 = pack_bf16(pe[0], pe[1]);
    const uint32_t b1 = pack_bf16(pe[2], pe[3]);
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      o[j][0] *= alpha0;
      o[j][1] *= alpha1;
      o[j][2] *= alpha0;
      o[j][3] *= alpha1;
      mma_bf16(o[j], __byte_perm(vw[0][j], vw[1][j], 0x5410u),
               __byte_perm(vw[0][j], vw[1][j], 0x7632u),
               __byte_perm(vw[2][j], vw[3][j], 0x5410u),
               __byte_perm(vw[2][j], vw[3][j], 0x7632u), b0, b1);
    }
  }

  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  if (r < G && t == 0) {
    st.m[warp][r] = m * 0.6931471805599453f;   // back to natural-log units
    st.l[warp][r] = l;
  }
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int head = 2 * t + (c & 1);
      if (head < G) st.acc[warp][head][HD / 8 * r + 2 * j + (c >> 1)] = o[j][c];
    }
}

template <typename T, int HD, int G>
__global__ void __launch_bounds__(THREADS, 2) decode_kernel(Args a) {
  __shared__ WarpStates<HD, G> st;
  __shared__ float bm[G], bl[G];      // this block's combined state
  __shared__ float bacc[G][HD];

  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x;            // the cluster spans the grid's x
  const int rank = static_cast<int>(cluster.block_rank());
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int lo = static_cast<int>(static_cast<int64_t>(rank) * a.W / C);
  const int hi = static_cast<int>(static_cast<int64_t>(rank + 1) * a.W / C);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb;
  const T* kc = static_cast<const T*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const T* vc = static_cast<const T*>(a.v) + b * a.v_sb + kh * a.v_sh;
  const int* sp = a.slot_pos + b * a.sp_sb;
  const int p = a.pos[b];

  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    warp_loop_tc<HD, G>(a, q, kc, vc, sp, p, kh, lo, hi, warp, lane, st);
  else
    warp_loop_simt<HD, G>(a, q, kc, vc, sp, p, kh, lo, hi, warp, lane, st);
  __syncthreads();

  // the block's state: its warps combined, not yet normalised
  for (int i = threadIdx.x; i < G * HD; i += THREADS) {
    const int g = i / HD, d = i % HD;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, st.m[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float e = expf(st.m[w][g] - mx);
      L = fmaf(st.l[w][g], e, L);
      A = fmaf(st.acc[w][g][d], e, A);
    }
    bacc[g][d] = A;
    if (d == 0) {
      bm[g] = mx;
      bl[g] = L;
    }
  }
  cluster.sync();                     // every block's state is in its shared memory

  // each rank combines a slice of the outputs from every rank's state,
  // read through distributed shared memory
  T* o = static_cast<T*>(a.o) + b * a.o_sb;
  const int per = (G * HD + C - 1) / C;
  for (int i = rank * per + threadIdx.x; i < min(G * HD, (rank + 1) * per); i += THREADS) {
    const int g = i / HD, d = i % HD;
    float mr[MAX_CLUSTER], lr[MAX_CLUSTER], ar[MAX_CLUSTER];
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r) {
      if (r < C) {
        mr[r] = cluster.map_shared_rank(&bm[0], r)[g];
        lr[r] = cluster.map_shared_rank(&bl[0], r)[g];
        ar[r] = cluster.map_shared_rank(&bacc[0][0], r)[i];
      }
    }
    float M = NEG_INF;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < C) M = fmaxf(M, mr[r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r) {
      if (r < C) {
        const float e = expf(mr[r] - M);
        L = fmaf(lr[r], e, L);
        A = fmaf(ar[r], e, A);
      }
    }
    o[(kh * G + g) * a.o_sh + d] = from_f32<T>(A / fmaxf(L, 1e-30f));
  }
  cluster.sync();                     // no block exits while another may read it
}

template <typename T, int HD, int G>
int launch(const Args& a, int B, int K, cudaStream_t stream) {
  const int C = cluster_size(a.W, B, K);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, K, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, decode_kernel<T, HD, G>, a));
}

template <typename T, int HD>
int dispatch_g(int G, const Args& a, int B, int K, cudaStream_t st) {
  switch (G) {
    case 1: return launch<T, HD, 1>(a, B, K, st);
    case 2: return launch<T, HD, 2>(a, B, K, st);
    case 4: return launch<T, HD, 4>(a, B, K, st);
    case 5: return launch<T, HD, 5>(a, B, K, st);
    case 8: return launch<T, HD, 8>(a, B, K, st);
    default: return -1;
  }
}

template <typename T>
int dispatch_hd(int hd, int G, const Args& a, int B, int K, cudaStream_t st) {
  switch (hd) {
    case 16: return dispatch_g<T, 16>(G, a, B, K, st);
    case 32: return dispatch_g<T, 32>(G, a, B, K, st);
    case 64: return dispatch_g<T, 64>(G, a, B, K, st);
    case 128: return dispatch_g<T, 128>(G, a, B, K, st);
    default: return -1;
  }
}

}  // namespace

// The number of blocks in the cluster that splits a cache of W slots of
// each of B * K (batch, kv head) pairs.
extern "C" int flash_decode_cluster_size(int W, int B, int K) { return cluster_size(W, B, K); }

// q, o: logical (B, H, hd) with (batch, head) element strides; k, v caches:
// logical (B, W, K, hd) with (batch, slot, head) strides; head_dim
// contiguous everywhere. slot_pos: int32 (B, W), slots contiguous; pos:
// int32 (B,), contiguous. dtype: 0 = float32, 1 = bfloat16. One launch
// with a cluster of flash_decode_cluster_size(W, B, K) blocks. Returns 0, a
// cudaError_t, or -1 for a dtype, head_dim or group size the kernel does
// not take.
extern "C" int flash_decode_fwd(int dtype, const void* q, const void* k, const void* v,
                                const void* slot_pos, const void* pos, void* o,
                                int B, int H, int K, int W, int hd,
                                int64_t q_sb, int64_t q_sh,
                                int64_t k_sb, int64_t k_sw, int64_t k_sh,
                                int64_t v_sb, int64_t v_sw, int64_t v_sh,
                                int64_t o_sb, int64_t o_sh, int64_t sp_sb,
                                int window, void* stream) {
  if (B <= 0 || H <= 0 || K <= 0 || H % K != 0 || W <= 0) return -1;
  Args a;
  a.q = q; a.k = k; a.v = v;
  a.slot_pos = static_cast<const int*>(slot_pos);
  a.pos = static_cast<const int*>(pos);
  a.o = o;
  a.q_sb = q_sb; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_sw = k_sw; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_sw = v_sw; a.v_sh = v_sh;
  a.o_sb = o_sb; a.o_sh = o_sh; a.sp_sb = sp_sb;
  a.W = W; a.window = window;
  a.scale = 1.0f / sqrtf((float)hd);
  const int G = H / K;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_hd<float>(hd, G, a, B, K, st);
  if (dtype == 1) return dispatch_hd<__nv_bfloat16>(hd, G, a, B, K, st);
  return -1;
}
