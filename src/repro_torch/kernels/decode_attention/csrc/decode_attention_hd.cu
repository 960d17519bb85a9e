// One-token decode attention on a head_dim slice of a ring KV cache, for
// Hopper (sm_90a): two kernels, with a sum over the ranks between them.
//
// What they replace: no Pallas kernel. Under the reference's decode cache
// layout (src/repro/launch/sharding.py cache_spec: the K/V cache's
// head_dim over `model`), GSPMD partitions the plain layer function
// src/repro/models/layers.py::decode_attention so that each device holds
// an hd slice of every head: its q . k is a partial dot product, summed
// over `model` by "one small score all-reduce" before the softmax. The
// port runs that as
//   decode_scores_hd: s[b, h, w] = q[b, h, :] . k[b, w, h / G, :] over the
//                     slice, f32, unscaled, every slot;
//   (the wrapper's caller sums s over `model`)
//   decode_values_hd: the softmax of the summed scores, scaled by
//                     1/sqrt of the FULL head_dim, with the slots' validity
//                     from slot_pos, pos and the window exactly as
//                     ref.py::decode_ref applies it (masked scores -1e30,
//                     the sum clamped at 1e-30), then p . v over the
//                     slice, written in the cache's dtype.
// Wrappers: ops.py::decode_scores_hd / decode_values_hd; plain versions
// ref.py::decode_scores_hd_ref / decode_values_hd_ref.
//
// What bounds them on the H100: device memory. A slice holds 8-64 of a
// head's 128 dims (4 of hymba-1.5b's 64 over `model` 16), so each cache
// byte is used for 2 * G / hd_s ... 2 * G FLOPs, and the scores
// themselves (4 bytes a (head, slot)) are as many bytes as the K slice at
// hd_s 8 and G 4, twice them at hd_s 4 and G 5: the least time is the K
// or V slice's bytes plus the scores' bytes over 3.35 TB/s.
//
// Design (a first, simple version):
// * scores: grid (K, W / 128, B), one thread a slot of one kv head; the
//   block's G query heads (hd_s f32 each) in shared memory, the slot's K
//   row read as 16-byte vectors (the wrapper checks the alignment), G
//   dot products in registers, each written to its head's row of s, so a
//   warp writes 32 consecutive floats. The K blocks of one slot tile are
//   launched next to each other, so a 32-byte sector of the (B, W, K,
//   hd_s) layout that several kv heads share is read from device memory
//   once and from L2 after. A bf16 row of 4 is one 8-byte vector (the
//   wrapper checks 8-byte alignment for it).
// * values: the W slots of each (kv head, batch) split across the C
//   blocks of a thread-block cluster (grid (C, K, B), C chosen as
//   flash_decode chooses it: a power of two up to 8, at least 128 slots
//   a block, about one wave of blocks), all G q heads of the kv head in
//   a block, so each V byte is read once. Eight warps walk the block's
//   slots 32 at a time, one pass with an online softmax: each lane takes
//   one slot's G scores (one exponential a slot and head), the warp's
//   max rescales its running state, and the warp, LPS = min(hd_s, 32)
//   lanes a slot and 32 / LPS slots at once (8 at hd_s 4), adds weight x
//   V row to per-lane sums, the weights passed by shuffles. The warps' states
//   are combined in shared memory, then the blocks' through distributed
//   shared memory with exp(m_i - M) weights, as in decode_attention.cu.
//   (The first version, one block a (batch, q head) and two passes over
//   the scores, read each V slice G times and trailed the nearest
//   PyTorch expression.) No atomics: two runs agree bit for bit.
// Both kernels are instantiated for two group bounds, 4 and 8, with the
// group size G read at run time: 20 instances each (2 dtypes x 5 slices
// x 2 bounds) rather than 80, which halved the library's build.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int S_THREADS = 128;          // slots a block of the scores kernel
constexpr int V_WARPS = 8;              // warps a block of the values kernel
constexpr int V_THREADS = V_WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_CLUSTER = 8;          // the portable cluster size
constexpr int MIN_SLOTS = 128;          // least slots a block of a cluster

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

// The blocks of one values cluster, as flash_decode chooses them: the
// largest power of two up to 8 that keeps at least MIN_SLOTS slots a block
// and B * K * C blocks within about one wave (5/4 of the SMs).
int cluster_size(int W, int B, int K) {
  const int sms = sm_count();
  int c = MAX_CLUSTER;
  while (c > 1 && (c * MIN_SLOTS > W || (sms > 0 && B * K * c > sms + sms / 4))) c /= 2;
  return c;
}

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// HS elements of T, as floats, in vectors of VEC bytes: 16, or 8 where
// the row is 8 bytes (a bf16 row of 4); src aligned to VEC.
template <typename T, int HS>
__device__ __forceinline__ void load_row(float (&r)[HS], const T* src) {
  constexpr int VEC = HS * sizeof(T) < 16 ? HS * sizeof(T) : 16;
  constexpr int WORDS = VEC / 4;         // 32-bit words a vector
  constexpr int PER = VEC / sizeof(T);   // elements a vector
  static_assert((VEC == 16 || VEC == 8) && HS % PER == 0,
                "a row is whole 16-byte vectors, or one 8-byte vector");
#pragma unroll
  for (int i = 0; i < HS / PER; ++i) {
    uint32_t w[WORDS];
    if constexpr (VEC == 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(src) + i);
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
    } else {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(src) + i);
      w[0] = v.x;
      w[1] = v.y;
    }
#pragma unroll
    for (int j = 0; j < WORDS; ++j) {
      if constexpr (std::is_same<T, float>::value) {
        r[PER * i + j] = __uint_as_float(w[j]);
      } else {
        __nv_bfloat162 h;
        *reinterpret_cast<uint32_t*>(&h) = w[j];
        const float2 f = __bfloat1622float2(h);
        r[PER * i + 2 * j] = f.x;
        r[PER * i + 2 * j + 1] = f.y;
      }
    }
  }
}

struct ScoresArgs {
  const void* q;      // logical (B, H, hs): strides q_sb, q_sh
  const void* k;      // logical (B, W, K, hs): strides k_sb, k_sw, k_sh
  float* s;           // (B, H, W), contiguous
  int64_t q_sb, q_sh, k_sb, k_sw, k_sh;
  int H, W, G;
};

// MAXG: the largest group size of the instance (4 or 8); the group size G
// itself is read at run time, so one instance serves G 1-4 or 5-8.
template <typename T, int HS, int MAXG>
__global__ void __launch_bounds__(S_THREADS) scores_kernel(ScoresArgs a) {
  const int kh = blockIdx.x, b = blockIdx.z;
  const int w = blockIdx.y * S_THREADS + threadIdx.x;
  const int G = a.G;
  __shared__ float qs[MAXG][HS];
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb;
  for (int i = threadIdx.x; i < MAXG * HS; i += S_THREADS) {
    const int g = i / HS, d = i % HS;
    qs[g][d] = g < G ? to_f32(q[(int64_t)(kh * G + g) * a.q_sh + d]) : 0.f;
  }
  __syncthreads();
  if (w >= a.W) return;
  float kr[HS];
  load_row<T, HS>(kr, static_cast<const T*>(a.k) + b * a.k_sb + (int64_t)w * a.k_sw +
                          (int64_t)kh * a.k_sh);
  float* out = a.s + ((int64_t)b * a.H + kh * G) * a.W + w;
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < HS; ++d) acc = fmaf(qs[g][d], kr[d], acc);
    if (g < G) out[(int64_t)g * a.W] = acc;
  }
}

struct ValuesArgs {
  const float* s;     // logical (B, H, W): strides s_sb, s_sh
  const void* v;      // logical (B, W, K, hs): strides v_sb, v_sw, v_sh
  const int* slot_pos;  // (B, W), row stride sp_sb
  const int* pos;     // (B,)
  void* o;            // logical (B, H, hs): strides o_sb, o_sh
  int64_t s_sb, s_sh, v_sb, v_sw, v_sh, sp_sb, o_sb, o_sh;
  int H, K, W, window, G;
  float scale;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

// The partial softmax state of every warp of a block, in shared memory:
// running max, sum and (unnormalised) p . v per q head of the kv head.
template <int HS, int MAXG>
struct WarpStates {
  float m[V_WARPS][MAXG], l[V_WARPS][MAXG];
  float acc[V_WARPS][MAXG][HS];
};

// MAXG as in scores_kernel: the registers and shared memory are sized for
// it, the loops stop at the run-time G.
template <typename T, int HS, int MAXG>
__global__ void __launch_bounds__(V_THREADS) values_kernel(ValuesArgs a) {
  constexpr int LPS = HS < 32 ? HS : 32;  // lanes a slot
  constexpr int SPW = 32 / LPS;           // slots a warp at once
  constexpr int PER = HS / LPS;           // dims a lane
  static_assert(LPS * PER == HS && SPW * LPS == 32, "hd slice 4, 8, 16, 32 or 64");
  __shared__ WarpStates<HS, MAXG> st;
  __shared__ float bm[MAXG], bl[MAXG], bacc[MAXG][HS];
  const int G = a.G;

  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x;              // the cluster spans the grid's x
  const int rank = static_cast<int>(cluster.block_rank());
  const int kh = blockIdx.y, b = blockIdx.z;
  const int lo = static_cast<int>((int64_t)a.W * rank / C);
  const int hi = static_cast<int>((int64_t)a.W * (rank + 1) / C);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane / LPS, dl = lane % LPS;
  const float* srow = a.s + b * a.s_sb + (int64_t)kh * G * a.s_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + (int64_t)kh * a.v_sh;
  const int* sp = a.slot_pos + b * a.sp_sb;
  const int p = a.pos[b];

  float m[MAXG], l[MAXG], acc[MAXG][PER];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < PER; ++j) acc[g][j] = 0.f;
  }
  for (int base = lo + warp * 32; base < hi; base += V_THREADS) {
    // one slot a lane: its scores, masked (-1e30) where not valid, -inf
    // past the range (they weigh nothing even when no slot is valid)
    const int w = base + lane;
    bool ok = false;
    if (w < hi) {
      const int t = sp[w];
      ok = t >= 0 && t <= p && (a.window <= 0 || p - t < a.window);
    }
    float pw[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      // heads past G run on a masked score and are never written: no
      // branch in the loop, so the G chains interleave as with G fixed
      const float sc = g >= G ? NEG_INF
                       : w >= hi ? -INFINITY
                       : ok ? srow[g * a.s_sh + w] * a.scale : NEG_INF;
      const float m_new = fmaxf(m[g], warp_max(sc));
      const float alpha = expf(m[g] - m_new);
      pw[g] = expf(sc - m_new);
      l[g] = fmaf(l[g], alpha, pw[g]);
#pragma unroll
      for (int j = 0; j < PER; ++j) acc[g][j] *= alpha;
      m[g] = m_new;
    }
    // weight x V: LPS lanes a slot, SPW slots at once, weights by shuffle
#pragma unroll
    for (int t = 0; t < LPS; ++t) {
      const int i = t * SPW + sub;
      float pi[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) pi[g] = __shfl_sync(FULL, pw[g], i);
      if (base + i < hi) {
        const T* row = vb + (int64_t)(base + i) * a.v_sw;
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const float v = to_f32(row[dl + LPS * j]);
#pragma unroll
          for (int g = 0; g < MAXG; ++g) acc[g][j] = fmaf(pi[g], v, acc[g][j]);
        }
      }
    }
  }
  // the warp's state: sums over its lanes (the weights) and over the
  // lanes of one dim (p . v)
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G) {
      l[g] = warp_sum(l[g]);
#pragma unroll
      for (int off = 16; off >= LPS; off >>= 1) {
#pragma unroll
        for (int j = 0; j < PER; ++j) acc[g][j] += __shfl_xor_sync(FULL, acc[g][j], off);
      }
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
  __syncthreads();

  // the block's state: its warps combined (a warp with no slot has
  // m = -inf and weighs 0)
  for (int i = tid; i < G * HS; i += V_THREADS) {
    const int g = i / HS, d = i % HS;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < V_WARPS; ++w) mx = fmaxf(mx, st.m[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < V_WARPS; ++w) {
      const float e = st.m[w][g] == -INFINITY ? 0.f : expf(st.m[w][g] - mx);
      L = fmaf(st.l[w][g], e, L);
      A = fmaf(st.acc[w][g][d], e, A);
    }
    bacc[g][d] = A;
    if (d == 0) {
      bm[g] = mx;
      bl[g] = L;
    }
  }
  cluster.sync();                       // every block's state is in its shared memory

  // each rank combines a slice of the outputs from every rank's state,
  // read through distributed shared memory
  T* o = static_cast<T*>(a.o) + b * a.o_sb;
  const int per = (G * HS + C - 1) / C;
  for (int i = rank * per + tid; i < min(G * HS, (rank + 1) * per); i += V_THREADS) {
    const int g = i / HS, d = i % HS;
    float mr[MAX_CLUSTER], lr[MAX_CLUSTER], ar[MAX_CLUSTER];
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r) {
      if (r < C) {
        mr[r] = cluster.map_shared_rank(&bm[0], r)[g];
        lr[r] = cluster.map_shared_rank(&bl[0], r)[g];
        ar[r] = cluster.map_shared_rank(&bacc[0][0], r)[i];
      }
    }
    float M = -INFINITY;
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
    o[(int64_t)(kh * G + g) * a.o_sh + d] = from_f32<T>(A / fmaxf(L, 1e-30f));
  }
  cluster.sync();                       // no block exits while another may read it
}

template <typename T, int HS>
int launch_scores(const ScoresArgs& a, int B, int K, cudaStream_t stream) {
  const dim3 grid(K, (a.W + S_THREADS - 1) / S_THREADS, B);
  if (a.G <= 4)
    scores_kernel<T, HS, 4><<<grid, S_THREADS, 0, stream>>>(a);
  else
    scores_kernel<T, HS, 8><<<grid, S_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int scores_by_slice(const ScoresArgs& a, int B, int K, int hs, cudaStream_t st) {
  switch (hs) {
    case 4: return launch_scores<T, 4>(a, B, K, st);
    case 8: return launch_scores<T, 8>(a, B, K, st);
    case 16: return launch_scores<T, 16>(a, B, K, st);
    case 32: return launch_scores<T, 32>(a, B, K, st);
    case 64: return launch_scores<T, 64>(a, B, K, st);
    default: return -1;
  }
}

template <typename T, int HS, int MAXG>
int launch_values(const ValuesArgs& a, int B, cudaStream_t stream) {
  const int C = cluster_size(a.W, B, a.K);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, a.K, B);
  cfg.blockDim = dim3(V_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, values_kernel<T, HS, MAXG>, a));
}

template <typename T, int HS>
int values_by_group(const ValuesArgs& a, int B, cudaStream_t st) {
  return a.G <= 4 ? launch_values<T, HS, 4>(a, B, st) : launch_values<T, HS, 8>(a, B, st);
}

template <typename T>
int values_by_slice(const ValuesArgs& a, int B, int hs, cudaStream_t st) {
  switch (hs) {
    case 4: return values_by_group<T, 4>(a, B, st);
    case 8: return values_by_group<T, 8>(a, B, st);
    case 16: return values_by_group<T, 16>(a, B, st);
    case 32: return values_by_group<T, 32>(a, B, st);
    case 64: return values_by_group<T, 64>(a, B, st);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 f32, 1 bf16. Returns 0, -1 for arguments the kernel does not
// take, or the CUDA error of the launch.
extern "C" int decode_scores_hd(int dtype, const void* q, const void* k, float* s, int B,
                                int H, int K, int W, int hs, int64_t q_sb, int64_t q_sh,
                                int64_t k_sb, int64_t k_sw, int64_t k_sh, void* stream) {
  if (B <= 0 || K <= 0 || W <= 0 || H % K != 0) return -1;
  const int G = H / K;
  if (G < 1 || G > 8) return -1;
  const ScoresArgs a{q, k, s, q_sb, q_sh, k_sb, k_sw, k_sh, H, W, G};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return scores_by_slice<float>(a, B, K, hs, st);
  if (dtype == 1) return scores_by_slice<__nv_bfloat16>(a, B, K, hs, st);
  return -1;
}

extern "C" int decode_values_hd(int dtype, const float* s, const void* v, const int* slot_pos,
                                const int* pos, void* o, int B, int H, int K, int W, int hs,
                                int64_t s_sb, int64_t s_sh, int64_t v_sb, int64_t v_sw,
                                int64_t v_sh, int64_t sp_sb, int64_t o_sb, int64_t o_sh,
                                int window, float scale, void* stream) {
  if (B <= 0 || K <= 0 || W <= 0 || H % K != 0 || H / K > 8) return -1;
  const ValuesArgs a{s, v, slot_pos, pos, o, s_sb, s_sh, v_sb, v_sw, v_sh, sp_sb,
                     o_sb, o_sh, H, K, W, window, H / K, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return values_by_slice<float>(a, B, hs, st);
  if (dtype == 1) return values_by_slice<__nv_bfloat16>(a, B, hs, st);
  return -1;
}
