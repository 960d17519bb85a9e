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
// cache's bytes over 3.35 TB/s.
//
// Design: one block per (kv head, batch) handles all G q heads of that kv
// head, so each cache byte is read from device memory once (the Pallas
// grid (B, H, nk) streams each kv head G times). The cache is read in the
// model's (B, W, K, hd) layout through strides: no transposed copy of the
// cache per layer and step. Eight warps split the slots; each warp takes
// four slots per step so that their loads are in flight together, keeps an
// f32 running max, sum and accumulator per q head in registers (lane i
// owns dims i, i + 32, ...), and the warps' partial states are combined in
// shared memory at the end. slot_pos and pos are read on the device: no
// host synchronisation. With B * K blocks the card is far from full at
// small batch; splitting W across blocks is the next step.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;                 // warps per block
constexpr int THREADS = NW * 32;
constexpr int U = 4;                  // slots per warp per step
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

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

template <typename T, int HD, int G>
__global__ void __launch_bounds__(THREADS) decode_kernel(Args a) {
  constexpr int PER = HD / 32;        // dims per lane
  __shared__ float ms[NW][G], ls[NW][G];
  __shared__ float accs[NW][G][HD];

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb;
  const T* kc = static_cast<const T*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const T* vc = static_cast<const T*>(a.v) + b * a.v_sb + kh * a.v_sh;
  const int* sp = a.slot_pos + b * a.sp_sb;
  const int p = a.pos[b];

  float qr[G][PER], m[G], l[G], acc[G][PER];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      qr[g][j] = to_f32(q[(kh * G + g) * a.q_sh + lane + 32 * j]) * a.scale;
      acc[g][j] = 0.f;
    }
  }

  for (int w0 = warp * U; w0 < a.W; w0 += NW * U) {
    float kv[U][PER], vv[U][PER];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int w = w0 + u;
      const bool in = w < a.W;
      const int s = in ? sp[w] : -1;
      ok[u] = in && s >= 0 && s <= p && (a.window <= 0 || p - s < a.window);
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        kv[u][j] = in ? to_f32(kc[w * a.k_sw + lane + 32 * j]) : 0.f;
        vv[u][j] = in ? to_f32(vc[w * a.v_sw + lane + 32 * j]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (w0 + u >= a.W) break;       // warp-uniform
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < PER; ++j) s = fmaf(qr[g][j], kv[u][j], s);
        s = warp_sum(s);
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

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      ms[warp][g] = m[g];
      ls[warp][g] = l[g];
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) accs[warp][g][lane + 32 * j] = acc[g][j];
  }
  __syncthreads();

  T* o = static_cast<T*>(a.o) + b * a.o_sb;
  for (int i = threadIdx.x; i < G * HD; i += THREADS) {
    const int g = i / HD, d = i % HD;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, ms[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float e = expf(ms[w][g] - mx);
      L = fmaf(ls[w][g], e, L);
      A = fmaf(accs[w][g][d], e, A);
    }
    o[(kh * G + g) * a.o_sh + d] = from_f32<T>(A / fmaxf(L, 1e-30f));
  }
}

template <typename T, int HD, int G>
int launch(const Args& a, int B, int K, cudaStream_t stream) {
  decode_kernel<T, HD, G><<<dim3(K, B), THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
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
    case 32: return dispatch_g<T, 32>(G, a, B, K, st);
    case 64: return dispatch_g<T, 64>(G, a, B, K, st);
    case 128: return dispatch_g<T, 128>(G, a, B, K, st);
    default: return -1;
  }
}

}  // namespace

// q, o: logical (B, H, hd) with (batch, head) element strides; k, v caches:
// logical (B, W, K, hd) with (batch, slot, head) strides; head_dim
// contiguous everywhere. slot_pos: int32 (B, W), slots contiguous; pos:
// int32 (B,), contiguous. dtype: 0 = float32, 1 = bfloat16. Returns 0, a
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
