// Mamba-1 selective scan for Hopper (sm_90a), the port of the TPU kernel
// src/repro/kernels/ssm_scan/kernel.py:67 (ssm_scan; body _ssm_kernel,
// wrapper ops.py::selective_scan, oracle ref.py::ssm_scan_ref).
//
// What it computes: for each (b, channel d, state n), in time order,
//   h_t = exp(dt_t * A[d, n]) * h_{t-1} + (dt_t * x_t) * B_t[n]
//   y_t[d] = sum_n h_t[n] * C_t[n]
// from h0, and writes y (B, S, di) and the final state h_S (B, di, N),
// all in f32 (x may come in bf16 and is widened on load).
//
// What bounds it on the H100: instruction issue and the exponentials
// first, then bytes. Each state and step needs one exponential (one
// MUFU.EX2; the special-function units do 16 a clock per SM) and about
// four f32 operations (dt * A, dtx * B, the fma into h and the fma into
// y); per (b, t, d) the kernel reads dt (4 bytes) and x (2 or 4) and
// writes y (4). At the Falcon-Mamba serve shape (B = 1, S = 2048,
// di = 8192, N = 16, x bf16) that is 268 M exponentials, about 0.073 ms
// on the special-function units at ~1.75 GHz, against 169.6 MB, 0.051 ms
// at 3.35 TB/s. A design that gives each state its own lane spends most
// of its issue slots around that work: every lane reloads dt and x,
// recomputes dt * x, runs an exact expf and joins a reduce-scatter over
// all N lanes. This one aims at 6-8 issue slots per state and step.
//
// Design, against that bound:
// * R states per thread: a thread owns one channel and R of its N states
//   (R in {2, 4, 8, 16}), so dt and dt * x are read once per thread and
//   step, and y's sum over its R states runs in registers with fma. Only
//   the rest crosses lanes: a reduce-scatter over the G = N / R lanes of a
//   channel, over G steps at once (G - 1 shuffles per G steps). B_t and
//   C_t come from shared memory as 16-byte (8-byte at R = 2) broadcast
//   loads.
// * A is scaled by log2(e) once, in registers, so each decay is one
//   multiply and one ex2.approx.ftz. Its relative error, about 2^-22,
//   stays within the 1e-4 tolerance over thousands of long-memory steps
//   (dt ~ 0.01, A = -(1..N), as init_mamba makes them).
// * The decays of the next group of G steps are computed beside the
//   recurrence of the current group, whose only loop-carried dependency
//   is the fma into h, so the exponentials' latency hides behind it.
// * Loads in flight: each chunk of T steps (T * CH = STAGE pairs of
//   (step, channel)) is copied by 16-byte cp.async (8-byte for bf16 x)
//   into shared memory while the previous chunk steps; each thread then
//   turns the pairs it copied into (dt, dt * x), and one barrier per
//   chunk publishes them. y goes out through shared memory as 16-byte
//   coalesced stores. A layout that is not 16-byte aligned (odd di, a
//   view at an odd offset) is loaded and stored with plain loads and
//   stores instead.
// * choose_r picks R from B * di and the SM count: the largest R that
//   still gives every SM a block. Fewer threads per channel cut the
//   instructions per state and step, but one block of 4 warps per SM is
//   the least that keeps each scheduler busy. chip_smoke.py phase 6 times
//   every R at both serve widths beside the rule's pick.
//
// The ragged tail of S and of di is masked, not padded: a masked step has
// dt = 0 (and x, B, C = 0), so its decay is exactly 1 and h passes through
// unchanged. B and C are read through their strides (on the model path
// they are column slices of one projection).
//
// For training the forward also writes the state at each chunk boundary
// (a template flag, STATES, so the serve paths run the code without it):
// hs[b][c] is the state entering step c * CHUNK, hs[b][0] = h0. The
// backward kernel (ssm_scan_bwd.cu) starts each chunk's recompute from
// these states, so it never rebuilds a state by dividing by a decay that
// may have underflowed. They cost (B, ceil(S / CHUNK), di, N) f32 of
// writes, 1/CHUNK of the states the recurrence passes through.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;          // one warp per scheduler of an SM
constexpr int STAGE = 1024;           // (step, channel) pairs per chunk
constexpr int CHUNK = 16;             // steps between two saved states (STATES);
                                      // ssm_scan_bwd.cu's SAVED
constexpr float LOG2E = 1.4426950408889634f;

// exp(dt * A) with a = A * log2(e): one multiply and one MUFU.EX2
__device__ __forceinline__ float decay(float dt, float a) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(dt * a));
  return y;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Args {
  const float* dt;        // logical (B, S, di): strides dt_sb, dt_ss
  const void* x;          // logical (B, S, di): strides x_sb, x_ss
  const float* bm;        // logical (B, S, N): strides b_sb, b_ss
  const float* cm;        // logical (B, S, N): strides c_sb, c_ss
  const float* A;         // (di, N), contiguous
  const float* h0;        // (B, di, N), contiguous
  float* y;               // logical (B, S, di): strides y_sb, y_ss
  float* h_final;         // (B, di, N), contiguous
  float* hs;              // (B, nc, di, N), contiguous: the states at the
                          // chunk boundaries (STATES only)
  int64_t dt_sb, dt_ss, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, y_sb, y_ss;
  int S, di, nc;          // nc = ceil(S / CHUNK)
  int vec;                // every row 16-byte aligned (8 for bf16 x), di % 4 == 0
};

// A thread owns channel tid / G and states (tid % G) * R .. + R - 1.
template <int N, int R>
struct Shape {
  static_assert(N % R == 0 && R >= 2, "R divides N");
  static constexpr int G = N / R;               // threads per channel
  static constexpr int CH = THREADS / G;        // channels per block
  static constexpr int T = STAGE / CH;          // steps per chunk
  static constexpr int LQ = T * CH / 4 / THREADS;   // quads of dt (and x) per thread
  static constexpr int LB = (T * N / 4 + THREADS - 1) / THREADS;   // ... of B (and C)
  static_assert(T % G == 0 && 32 % G == 0, "the reduce-scatter spans G steps");
  static_assert(LQ >= 1 && CH % 4 == 0 && N % 4 == 0, "quads of channels and states");
};

// Every array's size is a multiple of 16 bytes (T * CH = STAGE), so each
// starts 16-byte aligned.
template <typename TX, int N, int R>
struct __align__(16) Smem {
  static constexpr int CH = Shape<N, R>::CH, T = Shape<N, R>::T;
  float2 dtx[2][T][CH];   // (dt, dt * x) of each step and channel
  float raw_dt[T][CH];    // the next chunk's dt and x as cp.async lands them
  TX raw_x[T][CH];
  float b[2][T][N];
  float c[2][T][N];
  float y[2][T][CH + 4];  // rows 16-byte aligned for the quads
};

// R consecutive floats from shared memory, 16 (or 8) bytes at a time
template <int R>
__device__ __forceinline__ void lds(float (&v)[R], const float* p) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = f.x; v[4 * q + 1] = f.y; v[4 * q + 2] = f.z; v[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < R / 2; ++q) {
      const float2 f = reinterpret_cast<const float2*>(p)[q];
      v[2 * q] = f.x; v[2 * q + 1] = f.y;
    }
  }
}

// BYTES (8 or 16) from device to shared memory, asynchronously; zeros if !in
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(in ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(d), "l"(src), "r"(in ? 8 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Grid (ceil(di / CH), B): a block owns CH channels of one batch row and
// walks all S steps in chunks of T, carrying h in registers.
// R = 2: four blocks an SM (at most 128 registers a thread), else two.
template <typename TX, int N, int R, bool STATES>
__global__ void __launch_bounds__(THREADS, R == 2 ? 4 : 2) ssm_scan_kernel(Args a) {
  using SH = Shape<N, R>;
  constexpr int G = SH::G, CH = SH::CH, T = SH::T, LQ = SH::LQ, LB = SH::LB;
  extern __shared__ __align__(16) unsigned char smem[];
  Smem<TX, N, R>& sm = *reinterpret_cast<Smem<TX, N, R>*>(smem);
  const int tid = threadIdx.x, ch = tid / G, k = tid % G;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int d = d0 + ch;
  const bool active = d < a.di;
  const int64_t h_at = (static_cast<int64_t>(b) * a.di + d) * N + k * R;
  const int S = a.S;

  float A2[R], h[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    A2[j] = active ? a.A[static_cast<int64_t>(d) * N + k * R + j] * LOG2E : 0.f;
    h[j] = active ? a.h0[h_at + j] : 0.f;
  }
  // the state entering step t0 (a multiple of CHUNK) into hs[b][t0 / CHUNK]
  auto save = [&](int t0) {
    const int64_t at = ((static_cast<int64_t>(b) * a.nc + t0 / CHUNK) * a.di + d) * N + k * R;
#pragma unroll
    for (int j = 0; j < R; ++j) a.hs[at + j] = h[j];
  };
  if constexpr (STATES) {
    if (active && S > 0) save(0);
  }

  const float* dtp = a.dt + b * a.dt_sb;
  const TX* xp = static_cast<const TX*>(a.x) + b * a.x_sb;
  const float* bp = a.bm + b * a.b_sb;
  const float* cp = a.cm + b * a.c_sb;
  float* yp = a.y + b * a.y_sb;

  // The chunk at t0: dt and x into the staging arrays, B and C into
  // buffer buf, zeros outside S and di. Each thread takes quads of 4
  // channels (and of 4 states of B and C).
  auto fetch = [&](int t0, int buf) {
#pragma unroll
    for (int j = 0; j < LQ; ++j) {
      const int i = tid + j * THREADS, tt = i / (CH / 4), c = 4 * (i % (CH / 4));
      const int t = t0 + tt, dd = d0 + c;
      const float* ds = dtp + t * a.dt_ss + dd;
      const TX* xs = xp + t * a.x_ss + dd;
      if (a.vec) {                    // di % 4 == 0: a quad is in or out
        const bool in = t < S && dd < a.di;
        cp_async<16>(&sm.raw_dt[tt][c], in ? ds : dtp, in);
        cp_async<4 * sizeof(TX)>(&sm.raw_x[tt][c], in ? xs : xp, in);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = t < S && dd + e < a.di;
          sm.raw_dt[tt][c + e] = in ? ds[e] : 0.f;
          sm.raw_x[tt][c + e] = in ? xs[e] : TX(0.f);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < LB; ++j) {
      const int i = tid + j * THREADS, tt = i / (N / 4), n = 4 * (i % (N / 4)), t = t0 + tt;
      const bool in = t < S;
      if (i * 4 < T * N) {
        const float* bs = bp + t * a.b_ss + n;
        const float* cs = cp + t * a.c_ss + n;
        if (a.vec) {
          cp_async<16>(&sm.b[buf][tt][n], in ? bs : bp, in);
          cp_async<16>(&sm.c[buf][tt][n], in ? cs : cp, in);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sm.b[buf][tt][n + e] = in ? bs[e] : 0.f;
            sm.c[buf][tt][n + e] = in ? cs[e] : 0.f;
          }
        }
      }
    }
    cp_async_commit();
  };
  // Wait for this thread's copies and turn its own quads into (dt, dt * x)
  // in buffer buf; the barrier after it publishes them.
  auto settle = [&](int buf) {
    cp_async_wait_all();
#pragma unroll
    for (int j = 0; j < LQ; ++j) {
      const int i = tid + j * THREADS, tt = i / (CH / 4), c = 4 * (i % (CH / 4));
      const float4 dq = *reinterpret_cast<const float4*>(&sm.raw_dt[tt][c]);
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = to_f32(sm.raw_x[tt][c + e]);
      float4* o = reinterpret_cast<float4*>(&sm.dtx[buf][tt][c]);
      o[0] = make_float4(dq.x, dq.x * x[0], dq.y, dq.y * x[1]);
      o[1] = make_float4(dq.z, dq.z * x[2], dq.w, dq.w * x[3]);
    }
  };
  auto store_y = [&](int buf, int t0) {   // y of the chunk at t0, coalesced
#pragma unroll
    for (int j = 0; j < LQ; ++j) {
      const int i = tid + j * THREADS, tt = i / (CH / 4), c = 4 * (i % (CH / 4));
      const int t = t0 + tt, dd = d0 + c;
      const float4 v = *reinterpret_cast<const float4*>(&sm.y[buf][tt][c]);
      float* dst = yp + t * a.y_ss + dd;
      if (a.vec) {
        if (t < S && dd < a.di) *reinterpret_cast<float4*>(dst) = v;
      } else {
        const float e4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (t < S && dd + e < a.di) dst[e] = e4[e];
      }
    }
  };

  if (S > 0) {
    fetch(0, 0);
    settle(0);
    __syncthreads();
  }
  int buf = 0;
  for (int t0 = 0; t0 < S; t0 += T, buf ^= 1) {
    const bool next = t0 + T < S;
    if (next) fetch(t0 + T, buf ^ 1);   // in flight while this chunk steps
    if (t0 > 0) store_y(buf ^ 1, t0 - T);
    // The steps go in groups of G, the reduce-scatter's span. da and u
    // hold the decays and inputs of the current group; the next group's
    // are computed beside the current group's recurrence.
    float da[G][R], u[G][R];
#pragma unroll
    for (int s = 0; s < G; ++s) {
      const float2 v = sm.dtx[buf][s][ch];
      float bv[R];
      lds(bv, &sm.b[buf][s][k * R]);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        da[s][j] = decay(v.x, A2[j]);
        u[s][j] = v.y * bv[j];
      }
    }
#pragma unroll
    for (int g = 0; g < T; g += G) {
      const bool ahead = g + G < T;
      float p[G];                     // this thread's part of y, steps g .. g + G - 1
#pragma unroll
      for (int s = 0; s < G; ++s) {
        float2 v = make_float2(0.f, 0.f);
        float bv[R], cv[R];
        if (ahead) {                  // step s of the next group
          v = sm.dtx[buf][g + G + s][ch];
          lds(bv, &sm.b[buf][g + G + s][k * R]);
        }
        lds(cv, &sm.c[buf][g + s][k * R]);
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          h[j] = fmaf(h[j], da[s][j], u[s][j]);
          acc = fmaf(h[j], cv[j], acc);
          if (ahead) {
            da[s][j] = decay(v.x, A2[j]);
            u[s][j] = v.y * bv[j];
          }
        }
        p[s] = acc;
      }
      // Reduce-scatter over the channel's G lanes: after the round at
      // offset w a lane keeps the half of its steps whose bit w equals its
      // own, summed with its partner's; at the end lane k holds the whole
      // sum for step g + k.
#pragma unroll
      for (int w = G / 2; w >= 1; w >>= 1) {
        const bool upper = (k & w) != 0;
#pragma unroll
        for (int j = 0; j < w; ++j) {
          const float send = upper ? p[j] : p[j + w];
          const float keep = upper ? p[j + w] : p[j];
          p[j] = keep + __shfl_xor_sync(0xffffffffu, send, w);
        }
      }
      sm.y[buf][g + k][ch] = p[0];
      if constexpr (STATES) {         // after steps up to t0 + g + G - 1
        constexpr int EVERY = T < CHUNK ? T : CHUNK;
        const int t_end = t0 + g + G;
        if ((g + G) % EVERY == 0 && t_end % CHUNK == 0 && t_end < S && active) save(t_end);
      }
    }
    if (next) settle(buf ^ 1);
    __syncthreads();
  }
  if (S > 0) store_y(buf ^ 1, (S - 1) / T * T);
  if (active) {
#pragma unroll
    for (int j = 0; j < R; ++j) a.h_final[h_at + j] = h[j];
  }
}

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

// Blocks of a launch: B * ceil(di / CH), CH = THREADS * R / N.
int64_t blocks(int B, int di, int N, int R) {
  const int ch = THREADS * R / N;
  return static_cast<int64_t>(B) * ((di + ch - 1) / ch);
}

// States per thread: 4 where that still gives every SM a block, else 2
// (twice the blocks at more instructions per state and step). R = 8 and
// 16 halve and quarter the blocks again: at B = 1 and the serve widths
// (di 8192 and 3200) that leaves SMs without a block.
int choose_r(int B, int di, int N) {
  const int sms = sm_count();
  return sms > 0 && blocks(B, di, N, 4) < sms ? 2 : 4;
}

template <typename TX, int N, int R, bool STATES>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int CH = Shape<N, R>::CH;
  constexpr int SMEM = sizeof(Smem<TX, N, R>);   // above 48 KB at R = 2, x f32
  static const cudaError_t attr_rc = cudaFuncSetAttribute(
      ssm_scan_kernel<TX, N, R, STATES>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr_rc != cudaSuccess) return static_cast<int>(attr_rc);
  const dim3 grid((a.di + CH - 1) / CH, B);
  ssm_scan_kernel<TX, N, R, STATES><<<grid, THREADS, SMEM, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, int N, int R>
int launch(const Args& a, int B, cudaStream_t st) {
  return a.hs ? launch<TX, N, R, true>(a, B, st) : launch<TX, N, R, false>(a, B, st);
}

template <typename TX>
int dispatch(int N, int R, const Args& a, int B, cudaStream_t st) {
  if (N == 16) {
    switch (R) {
      case 2: return launch<TX, 16, 2>(a, B, st);
      case 4: return launch<TX, 16, 4>(a, B, st);
      case 8: return launch<TX, 16, 8>(a, B, st);
      case 16: return launch<TX, 16, 16>(a, B, st);
    }
  } else if (N == 8) {
    switch (R) {
      case 2: return launch<TX, 8, 2>(a, B, st);
      case 4: return launch<TX, 8, 4>(a, B, st);
      case 8: return launch<TX, 8, 8>(a, B, st);
    }
  }
  return -1;
}

}  // namespace

// The states per thread the kernel takes for these sizes on this card.
extern "C" int ssm_scan_states(int B, int di, int N) { return choose_r(B, di, N); }

// dt, Bm, Cm, A, h0, y, h_final: float32; x: float32 (x_dtype 0) or
// bfloat16 (x_dtype 1). dt, x, y: logical (B, S, di) with (batch, step)
// element strides; Bm, Cm: logical (B, S, N) with (batch, step) strides;
// the last dimension contiguous everywhere. A (di, N), h0 and h_final
// (B, di, N): contiguous. hs: null, or (B, ceil(S / chunk), di, N) f32
// contiguous for the states at the chunk boundaries, where chunk must be
// CHUNK. R: states per thread (2, 4, 8 or 16, dividing N), or 0 for
// ssm_scan_states' choice. One launch. Returns 0, a cudaError_t, or -1
// for arguments the kernel does not take (N other than 8 or 16, R
// outside that set, another chunk).
extern "C" int ssm_scan_fwd(int x_dtype, const void* dt, const void* x, const void* bm,
                            const void* cm, const void* A, const void* h0, void* y,
                            void* h_final, void* hs, int chunk, int B, int S, int di, int N,
                            int64_t dt_sb, int64_t dt_ss, int64_t x_sb, int64_t x_ss,
                            int64_t b_sb, int64_t b_ss, int64_t c_sb, int64_t c_ss,
                            int64_t y_sb, int64_t y_ss, int R, void* stream) {
  if (B <= 0 || S < 0 || di <= 0 || B > 65535 || (hs && chunk != CHUNK)) return -1;
  if (R == 0) R = choose_r(B, di, N);
  Args a;
  a.dt = static_cast<const float*>(dt);
  a.x = x;
  a.bm = static_cast<const float*>(bm);
  a.cm = static_cast<const float*>(cm);
  a.A = static_cast<const float*>(A);
  a.h0 = static_cast<const float*>(h0);
  a.y = static_cast<float*>(y);
  a.h_final = static_cast<float*>(h_final);
  a.hs = static_cast<float*>(hs);
  a.dt_sb = dt_sb; a.dt_ss = dt_ss; a.x_sb = x_sb; a.x_ss = x_ss;
  a.b_sb = b_sb; a.b_ss = b_ss; a.c_sb = c_sb; a.c_ss = c_ss;
  a.y_sb = y_sb; a.y_ss = y_ss;
  a.S = S; a.di = di; a.nc = (S + CHUNK - 1) / CHUNK;
  const int xe = x_dtype == 1 ? 2 : 4;   // bytes per element of x
  // base and row strides of a (., ., 4-element quad) layout aligned to quad bytes
  auto rows = [](const void* p, int64_t sb, int64_t ss, int elem, int quad) {
    return reinterpret_cast<uintptr_t>(p) % quad == 0 && (sb * elem) % quad == 0 &&
           (ss * elem) % quad == 0;
  };
  a.vec = di % 4 == 0 && rows(dt, dt_sb, dt_ss, 4, 16) && rows(x, x_sb, x_ss, xe, 4 * xe) &&
          rows(bm, b_sb, b_ss, 4, 16) && rows(cm, c_sb, c_ss, 4, 16) &&
          rows(y, y_sb, y_ss, 4, 16);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return dispatch<float>(N, R, a, B, st);
  if (x_dtype == 1) return dispatch<__nv_bfloat16>(N, R, a, B, st);
  return -1;
}
