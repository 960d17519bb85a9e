// The selective scan's backward for Hopper (sm_90a). No TPU kernel: it
// replaces XLA's autodiff of src/repro/models/mamba.py:53
// (ssm_scan_chunked), through which the reference trains; its Pallas
// kernel (src/repro/kernels/ssm_scan/kernel.py:67) has no VJP. Wrapper
// ops.py::selective_scan_bwd, oracle ref.py::ssm_scan_ref_bwd.
//
// What it computes: with the forward's a_t = exp(dt_t A[d, n]),
// u_t = dt_t x_t B_t[n], h_t = a_t h_{t-1} + u_t, y_t[d] = sum_n h_t C_t[n],
// and g_t = dL/dh_t = dy_t C_t + a_{t+1} g_{t+1} (g_S adds dh_final):
//   dC_t[n] = sum_d dy_t h_t             dB_t[n] = sum_d g_t dt_t x_t
//   d(dt)_t[d] = sum_n g_t (A a_t h_{t-1} + x_t B_t[n])
//   dx_t[d] = sum_n g_t dt_t B_t[n]      dA[d, n] = sum_{b,t} g_t dt_t a_t h_{t-1}
//   dh0 = a_1 g_1
// all in f32; dx is written in x's dtype (bf16 on the model path).
//
// What bounds it on the H100: instruction issue. Per state and step it
// needs one exponential (one MUFU.EX2, 16 a clock per SM) and about twenty
// f32 operations, and per step the sums across states (d(dt), dx) and
// across channels (dB, dC) cross lanes; per (b, t, d) it reads dt, x, dy
// and writes d(dt), dx, and it reads one saved state per interval. At
// falcon-mamba-7b's training shape (B 2 x S 4096 x di 8192 x N 16, 1.07e9
// state-steps) the bytes bound it at about 0.36 ms and the exponentials
// at 0.26 ms; the issue slots of the work below take several times that,
// so the design spends as few instructions a state-step as it can and
// keeps 16 warps an SM to issue them.
//
// Design:
// * One CTA of 128 threads per (batch row, block of CH channels), each
//   thread one channel and R of its N states (G = N / R lanes a channel).
//   The CTA walks the intervals of SAVED = 16 steps between the forward's
//   saved states (hs, one every SAVED steps) from the last, each in
//   sub-chunks of L = 32 / R steps from the last. Shared memory stays at or
//   under 56 KB and registers at 128 a thread, so 4 CTAs (16 warps) share
//   an SM.
// * Loads in flight: an interval's dt, x, dy, B, C and its saved state are
//   copied by cp.async (16 bytes, 8 for bf16 x or R = 2 states) into one of
//   two buffers while the previous interval is walked; a layout that is not
//   16-byte aligned is loaded with plain loads instead. Once landed, each
//   thread turns the dt and x it copied into (dt, dt * x). d(dt) and dx are
//   written in place of dy and dt in the buffer and go out as coalesced
//   stores after the interval.
// * One exponential a state-step: the sub-chunk's recompute, forward from
//   its starting state with the forward kernel's operations, keeps every
//   decay a_t in shared memory and the state entering each group of G
//   steps. The reverse walk rebuilds a group's G states in registers from
//   that state and the kept decays (one fma each, the forward's own), then
//   walks the group backwards carrying a_{t+1} g_{t+1} in registers. A
//   state is never rebuilt by dividing by a decay. Where SAVED > L (R 4:
//   two sub-chunks of 8 steps) the state entering the second comes from
//   one more pass over the interval's first 8 steps, whose decays are
//   computed again in the first's recompute: 1.5 exponentials a
//   state-step at R 4, one at R 2.
// * Sums in a fixed order, off the step's critical path. Over the N states
//   of a channel: per thread over its R states in order, then over the G
//   lanes by a reduce-scatter over the group's G steps at once (G - 1
//   shuffles per G steps; the lanes paired from the top bit down), so lane
//   k ends with step k's d(dt) and dx. Over channels (dB, dC): at every
//   step a reduce-scatter over the W = 32 / G channels of a warp (from the
//   top bit down); the steps are unrolled, so their shuffles overlap. Each
//   warp's rows go to shared memory, the block adds its warps in order, and
//   the CTAs of a thread-block cluster (up to 8 blocks of channels of one
//   batch row) add the blocks' rows through distributed shared memory in
//   rank order, one row per cluster into a workspace that fits in L2 (33.5
//   MB at falcon-mamba-7b's shape). A second kernel adds the clusters' rows
//   in order, and the batch rows' dA in order. No float atomics: two runs
//   give the same bits.
// * One cluster barrier an interval: arrive once the interval's rows are
//   written, wait (and add the previous interval's rows) after the next
//   interval's first recompute; two buffers of rows. The grid is padded to
//   a whole number of clusters with CTAs whose channels are all masked;
//   they walk and meet every barrier like the others. No CTA exits before
//   the last barrier, after which no peer reads its shared memory.
// * The decays use ex2.approx.ftz on A log2(e), as the forward; the
//   derivatives of exp(dt A) are in natural units (A a, dt a), so log2(e)
//   enters no gradient.
// * The ragged tail of S and of di is masked, as in the forward: a masked
//   step has dt = x = dy = B = C = 0, so its decay is 1, g passes through,
//   it adds nothing to dA, dB or dC, and its d(dt) and dx are not written.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MIN_BLOCKS = 4;         // CTAs an SM the registers allow: 16 warps
constexpr int MAX_CLUSTER = 8;        // the portable cluster size
constexpr int SAVED = 16;             // steps between two saved states: ssm_scan.cu's CHUNK
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int ilog2(int n) { return n > 1 ? 1 + ilog2(n / 2) : 0; }

__device__ __forceinline__ float decay(float dt, float a) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(dt * a));
  return y;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename TX> __device__ __forceinline__ TX from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// four floats to four aligned elements of TX
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
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
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

struct Args {
  const float* dt;        // logical (B, S, di): strides dt_sb, dt_ss
  const void* x;          // logical (B, S, di): strides x_sb, x_ss
  const float* bm;        // logical (B, S, N): strides b_sb, b_ss
  const float* cm;        // logical (B, S, N): strides c_sb, c_ss
  const float* A;         // (di, N), contiguous
  const float* hs;        // (B, nc, di, N): the forward's states, one every SAVED steps
  const float* dy;        // logical (B, S, di): strides dy_sb, dy_ss
  const float* dh_final;  // (B, di, N) or null (zero)
  float* ddt;             // (B, S, di), contiguous
  void* dx;               // (B, S, di) in x's dtype, contiguous
  float* ws;              // (B, ncl, nc * SAVED, 2N): each cluster's dB | dC rows
  float* ws_a;            // (B, di, N): each batch row's dA
  float* dh0;             // (B, di, N)
  int64_t dt_sb, dt_ss, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, dy_sb, dy_ss;
  int S, di, nc, ncl;     // nc = ceil(S / SAVED); ncl clusters a batch row
  int vec;                // every row 16-byte aligned (8 for bf16 x), di % 4 == 0
};

template <int N, int R>
struct Shape {
  static_assert(N % R == 0 && R >= 2, "R divides N");
  static constexpr int G = N / R;                   // lanes a channel
  static constexpr int CH = THREADS / G;            // channels a block
  static constexpr int W = 32 / G;                  // channels a warp
  static constexpr int L = 32 / R;                  // steps a sub-chunk
  static constexpr int NSUB = SAVED / L;            // sub-chunks an interval
  static_assert(SAVED % L == 0 && L % G == 0 && 32 % G == 0 && CH % 4 == 0 && N % 4 == 0,
                "whole groups, sub-chunks, warps of channels and quads");
};

// Every array's size is a multiple of 16 bytes, so each starts aligned.
template <typename TX, int N, int R>
struct __align__(16) Smem {
  using SH = Shape<N, R>;
  static constexpr int CH = SH::CH, L = SH::L, NSUB = SH::NSUB;
  float dt[2][SAVED][CH];   // an interval's dt as copied; dx (f32) in place after its walk
  float dy[2][SAVED][CH];   // ... its dy; d(dt) in place after its walk
  TX x[2][SAVED][CH];
  float b[2][SAVED][N];
  float c[2][SAVED][N];
  float2 dtx[SAVED][CH];    // the walked interval's (dt, dt * x)
  float h0[2][THREADS * R];                          // the state entering the interval
  float hsub[NSUB > 1 ? NSUB - 1 : 1][THREADS * R];  // ... entering sub-chunks 1 ..
  float a[L][THREADS * R];                           // the sub-chunk's decays
  float hg[L / SH::G][THREADS * R];                  // the state entering each group
  float part[2][WARPS][L][2 * N];                    // each warp's dB | dC rows
  float rows[2][SAVED][2 * N];                       // ... added over the warps
};

template <int R>
__device__ __forceinline__ void ld_row(float (&v)[R], const float* p) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int q = 0; q < R; q += 4) {
      const float4 f = reinterpret_cast<const float4*>(p)[q / 4];
      v[q] = f.x; v[q + 1] = f.y; v[q + 2] = f.z; v[q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < R; q += 2) {
      const float2 f = reinterpret_cast<const float2*>(p)[q / 2];
      v[q] = f.x; v[q + 1] = f.y;
    }
  }
}
template <int R>
__device__ __forceinline__ void st_row(float* p, const float (&v)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int q = 0; q < R; q += 4)
      reinterpret_cast<float4*>(p)[q / 4] = make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
  } else {
#pragma unroll
    for (int q = 0; q < R; q += 2) reinterpret_cast<float2*>(p)[q / 2] = make_float2(v[q], v[q + 1]);
  }
}

// Grid (ncl * cluster, B), clusters along x: the block's CH channels of
// batch row b, interval by interval from the last.
template <typename TX, int N, int R>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) ssm_scan_bwd_kernel(Args a) {
  using SH = Shape<N, R>;
  constexpr int G = SH::G, CH = SH::CH, W = SH::W, M = 2 * R, LW = ilog2(W);
  constexpr int L = SH::L, NSUB = SH::NSUB, ROW = 2 * N;
  constexpr int QUADS = (SAVED * CH / 4 + THREADS - 1) / THREADS;   // quads of dt a thread copies
  extern __shared__ __align__(16) unsigned char smem[];
  Smem<TX, N, R>& sm = *reinterpret_cast<Smem<TX, N, R>*>(smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, ch = tid / G, k = tid % G;
  const int lane = tid % 32, warp = tid / 32, cw = lane / G;   // cw: channel in the warp
  const int b = blockIdx.y, blk = blockIdx.x;
  const int d0 = blk * CH, d = d0 + ch;
  const bool active = d < a.di;
  const int64_t h_at = (static_cast<int64_t>(b) * a.di + d) * N + k * R;
  const int S = a.S;

  float An[R], A2[R], carry[R], dA[R];   // carry: a_{t+1} g_{t+1}
#pragma unroll
  for (int j = 0; j < R; ++j) {
    An[j] = active ? a.A[static_cast<int64_t>(d) * N + k * R + j] : 0.f;
    A2[j] = An[j] * LOG2E;
    carry[j] = active && a.dh_final ? a.dh_final[h_at + j] : 0.f;
    dA[j] = 0.f;
  }
  const float* dtp = a.dt + b * a.dt_sb;
  const TX* xp = static_cast<const TX*>(a.x) + b * a.x_sb;
  const float* dyp = a.dy + b * a.dy_sb;
  const float* bp = a.bm + b * a.b_sb;
  const float* cp = a.cm + b * a.c_sb;
  float* ddtp = a.ddt + static_cast<int64_t>(b) * S * a.di;
  TX* dxp = static_cast<TX*>(a.dx) + static_cast<int64_t>(b) * S * a.di;
  float* wsp = a.ws + (static_cast<int64_t>(b) * a.ncl + blk / CL) * a.nc * SAVED * ROW;

  // Interval c's inputs into buffer buf, zeros outside S and di, in quads
  // of 4 channels (and 4 states of B and C); its saved state.
  auto fetch = [&](int c, int buf) {
    const int t0 = c * SAVED;
#pragma unroll
    for (int j = 0; j < QUADS; ++j) {
      const int i = tid + j * THREADS;
      if (i >= SAVED * CH / 4) break;
      const int tt = i / (CH / 4), cc = 4 * (i % (CH / 4)), t = t0 + tt, dd = d0 + cc;
      const float* ds = dtp + t * a.dt_ss + dd;
      const float* ys = dyp + t * a.dy_ss + dd;
      const TX* xs = xp + t * a.x_ss + dd;
      if (a.vec) {                    // di % 4 == 0: a quad is in or out
        const bool in = t < S && dd < a.di;
        cp_async<16>(&sm.dt[buf][tt][cc], in ? ds : dtp, in);
        cp_async<16>(&sm.dy[buf][tt][cc], in ? ys : dyp, in);
        cp_async<4 * sizeof(TX)>(&sm.x[buf][tt][cc], in ? xs : xp, in);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = t < S && dd + e < a.di;
          sm.dt[buf][tt][cc + e] = in ? ds[e] : 0.f;
          sm.dy[buf][tt][cc + e] = in ? ys[e] : 0.f;
          sm.x[buf][tt][cc + e] = in ? xs[e] : from_f32<TX>(0.f);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < (SAVED * N / 4 + THREADS - 1) / THREADS; ++j) {
      const int i = tid + j * THREADS;
      if (i >= SAVED * N / 4) break;
      const int tt = i / (N / 4), n = 4 * (i % (N / 4)), t = t0 + tt;
      const bool in = t < S;
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
    const int64_t hs_at = ((static_cast<int64_t>(b) * a.nc + c) * a.di + d) * N + k * R;
    cp_async<4 * R>(&sm.h0[buf][tid * R], active ? a.hs + hs_at : a.hs, active);
    cp_async_commit();
  };
  // Turn the quads of dt and x this thread copied into buffer buf into
  // (dt, dt * x); the barrier after it publishes them.
  auto settle = [&](int buf) {
#pragma unroll
    for (int j = 0; j < QUADS; ++j) {
      const int i = tid + j * THREADS;
      if (i >= SAVED * CH / 4) break;
      const int tt = i / (CH / 4), cc = 4 * (i % (CH / 4));
      const float4 dq = *reinterpret_cast<const float4*>(&sm.dt[buf][tt][cc]);
      const float e[4] = {dq.x, dq.y, dq.z, dq.w};
#pragma unroll
      for (int f = 0; f < 4; ++f)
        sm.dtx[tt][cc + f] = make_float2(e[f], e[f] * to_f32(sm.x[buf][tt][cc + f]));
    }
  };
  // Interval c's d(dt) and dx from buffer buf, coalesced.
  auto store = [&](int c, int buf) {
    const int t0 = c * SAVED;
#pragma unroll
    for (int j = 0; j < QUADS; ++j) {
      const int i = tid + j * THREADS;
      const int tt = i / (CH / 4), cc = 4 * (i % (CH / 4)), t = t0 + tt, dd = d0 + cc;
      if (i >= SAVED * CH / 4 || t >= S) break;
      const int64_t at = static_cast<int64_t>(t) * a.di + dd;
      const float4 gd = *reinterpret_cast<const float4*>(&sm.dy[buf][tt][cc]);
      const float4 gx = *reinterpret_cast<const float4*>(&sm.dt[buf][tt][cc]);
      if (a.vec) {
        if (dd < a.di) {
          st4(ddtp + at, gd);
          st4(dxp + at, gx);
        }
      } else {
        const float e1[4] = {gd.x, gd.y, gd.z, gd.w}, e2[4] = {gx.x, gx.y, gx.z, gx.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (dd + e < a.di) {
            ddtp[at + e] = e1[e];
            dxp[at + e] = from_f32<TX>(e2[e]);
          }
      }
    }
  };
  // The block's dB | dC rows of the sub-chunk walked q-th: its warps'
  // rows added in order.
  auto block_sum = [&](int q, int c, int i0) {
    constexpr int Q4 = L * ROW / 4;               // quads of columns
#pragma unroll
    for (int j = 0; j < (Q4 + THREADS - 1) / THREADS; ++j) {
      const int o = tid + j * THREADS, i = o / (ROW / 4), col = 4 * (o % (ROW / 4));
      if (o < Q4) {
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
          const float4 v = *reinterpret_cast<const float4*>(&sm.part[q & 1][w][i][col]);
          s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
        }
        *reinterpret_cast<float4*>(&sm.rows[c & 1][i0 + i][col]) = s;
      }
    }
  };
  // The cluster's rows of interval c: rank r adds its share of them over
  // the ranks in order, from distributed shared memory.
  auto cluster_sum = [&](int c) {
    const int per = SAVED * ROW / CL;
    for (int o = tid; o < per; o += THREADS) {
      const int oo = rank * per + o, i = oo / ROW, col = oo % ROW;
      float v[MAX_CLUSTER];
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r)
        if (r < CL) v[r] = *cluster.map_shared_rank(&sm.rows[c & 1][i][col], r);
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r)
        if (r < CL) s += v[r];
      wsp[static_cast<int64_t>(c * SAVED + i) * ROW + col] = s;
    }
  };
  // One step of the forward's recurrence, as the forward kernel does it:
  // u = (dt x) B, h = fma(h, exp2(dt A log2 e), u); the decays into av.
  auto step = [&](float (&h)[R], float (&av)[R], int buf, int t) {
    const float2 v = sm.dtx[t][ch];
    const float dtv = v.x, dtx = v.y;
    float bv[R];
    ld_row(bv, &sm.b[buf][t][k * R]);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      av[j] = decay(dtv, A2[j]);
      h[j] = fmaf(h[j], av[j], dtx * bv[j]);
    }
  };

  if (a.nc > 0) fetch(a.nc - 1, (a.nc - 1) & 1);
  int q = 0;                          // sub-chunks walked
  for (int c = a.nc - 1; c >= 0; --c) {
    const int buf = c & 1;
    cp_async_wait_all();
    settle(buf);
    __syncthreads();                  // interval c is in buf; buf ^ 1 is stored
    if (c > 0) fetch(c - 1, buf ^ 1);   // in flight while this interval is walked
    const float* h_in = &sm.h0[buf][tid * R];
    if constexpr (NSUB > 1) {         // the states entering sub-chunks 1 ..
      float h[R], av[R];
      ld_row(h, h_in);
#pragma unroll
      for (int i = 0; i < (NSUB - 1) * L; ++i) {
        step(h, av, buf, i);
        if (i % L == L - 1) st_row(&sm.hsub[i / L][tid * R], h);
      }
    }
#pragma unroll 1
    for (int sub = NSUB - 1; sub >= 0; --sub) {
      const int i0 = sub * L;
      // The recompute: each step's decays, and the state entering each
      // group of G steps. Each thread writes and reads only its own slots.
      {
        float h[R], av[R];
        ld_row(h, sub == 0 ? h_in : &sm.hsub[sub > 0 ? sub - 1 : 0][tid * R]);
#pragma unroll
        for (int i = 0; i < L; ++i) {
          if (i % G == 0) st_row(&sm.hg[i / G][tid * R], h);
          step(h, av, buf, i0 + i);
          st_row(&sm.a[i][tid * R], av);
        }
      }
      // the previous interval's rows, now that every rank has written them
      if (sub == NSUB - 1 && c < a.nc - 1) {
        cluster_wait();
        cluster_sum(c + 1);
      }
      // The reverse walk, group by group from the last.
      for (int grp = L / G - 1; grp >= 0; --grp) {
        float hp[R], hh[G][R], av[G][R];   // the state entering the group; h_t; a_t
        ld_row(hp, &sm.hg[grp][tid * R]);
#pragma unroll
        for (int s = 0; s < G; ++s) {
          const int t = i0 + grp * G + s;
          const float dtx = sm.dtx[t][ch].y;
          float bv[R];
          ld_row(bv, &sm.b[buf][t][k * R]);
          ld_row(av[s], &sm.a[grp * G + s][tid * R]);
#pragma unroll
          for (int j = 0; j < R; ++j)
            hh[s][j] = fmaf(s ? hh[s - 1][j] : hp[j], av[s][j], dtx * bv[j]);
        }
        float sa[G], sx[G];   // per step: sum_n g A a h_{t-1}, sum_n g B
#pragma unroll
        for (int s = G - 1; s >= 0; --s) {
          const int i = grp * G + s, t = i0 + i;
          const float2 dv = sm.dtx[t][ch];
          const float dtv = dv.x, dtx = dv.y, dyv = sm.dy[buf][t][ch];
          float bv[R], cv[R], v[M];   // v: this thread's dB_t (first R) and dC_t (last R)
          ld_row(bv, &sm.b[buf][t][k * R]);
          ld_row(cv, &sm.c[buf][t][k * R]);
          float s_a = 0.f, s_x = 0.f;
#pragma unroll
          for (int j = 0; j < R; ++j) {
            const float ah = av[s][j] * (s ? hh[s - 1][j] : hp[j]);   // a_t h_{t-1}
            const float g = fmaf(dyv, cv[j], carry[j]);
            const float pg = g * ah;
            dA[j] = fmaf(pg, dtv, dA[j]);
            s_a = fmaf(pg, An[j], s_a);
            s_x = fmaf(g, bv[j], s_x);
            carry[j] = av[s][j] * g;
            v[j] = g * dtx;
            v[R + j] = dyv * hh[s][j];
          }
          sa[s] = s_a;
          sx[s] = s_x;
          // dB_t and dC_t over the warp's W channels: a reduce-scatter from
          // the top bit of the channel down, keeping halves while there are
          // values to split, then adding. Lane (cw, k) ends with the values
          // v[base .. base + M / W) (or, where M < W, one value shared by
          // W / M lanes).
#pragma unroll
          for (int r = 0; r < LW; ++r) {
            const int w = 16 >> r, half = M >> (r + 1);   // lanes apart, values kept
            if (half >= 1) {
              const bool upper = (lane & w) != 0;
#pragma unroll
              for (int j = 0; j < half; ++j) {
                const float send = upper ? v[j] : v[j + half];
                const float keep = upper ? v[j + half] : v[j];
                v[j] = keep + __shfl_xor_sync(FULL, send, w);
              }
            } else {
              v[0] += __shfl_xor_sync(FULL, v[0], w);
            }
          }
          constexpr int KEEP = M >= W ? M / W : 1;
          constexpr int SHARE = M >= W ? 1 : W / M;       // lanes holding one value
          if (cw % SHARE == 0) {
            const int base = cw / SHARE * KEEP;
#pragma unroll
            for (int j = 0; j < KEEP; ++j) {
              const int idx = base + j;                   // into this thread's v before the sum
              const int col = idx < R ? k * R + idx : N + k * R + idx - R;
              sm.part[q & 1][warp][i][col] = v[j];
            }
          }
        }
        // The channel's sums over its G lanes for the group's G steps: a
        // reduce-scatter from the top lane bit down; lane k ends with step
        // grp * G + k.
#pragma unroll
        for (int w = G / 2; w >= 1; w >>= 1) {
          const bool upper = (k & w) != 0;
#pragma unroll
          for (int j = 0; j < w; ++j) {
            const float send_a = upper ? sa[j] : sa[j + w], keep_a = upper ? sa[j + w] : sa[j];
            const float send_x = upper ? sx[j] : sx[j + w], keep_x = upper ? sx[j + w] : sx[j];
            sa[j] = keep_a + __shfl_xor_sync(FULL, send_a, w);
            sx[j] = keep_x + __shfl_xor_sync(FULL, send_x, w);
          }
        }
        __syncwarp();   // every lane of the channel has read the group's dy
        {
          const int t = i0 + grp * G + k;
          const float dtv = sm.dtx[t][ch].x, xv = to_f32(sm.x[buf][t][ch]);
          sm.dy[buf][t][ch] = fmaf(xv, sx[0], sa[0]);   // d(dt)
          sm.dt[buf][t][ch] = dtv * sx[0];             // dx
        }
      }
      __syncthreads();                // every warp's rows are written
      block_sum(q, c, i0);
      ++q;
    }
    cluster_arrive();                 // the interval's rows are written
    __syncthreads();                  // the interval's d(dt) and dx are in buf
    store(c, buf);
  }
  if (a.nc > 0) {
    cluster_wait();
    cluster_sum(0);
  }
  cluster_arrive();                   // no peer reads this block's rows any more
  cluster_wait();
  if (active) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      a.ws_a[h_at + j] = dA[j];
      a.dh0[h_at + j] = carry[j];
    }
  }
}

// dB and dC: each (b, t, n) the sum of the clusters' rows in cluster
// order; dA: each (d, n) the sum of the batch rows' in batch order.
__global__ void ssm_scan_bwd_sum_kernel(const float* ws, const float* ws_a, float* dB,
                                        float* dC, float* dA, int B, int S, int Sp, int ncl,
                                        int di, int N) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t nbc = static_cast<int64_t>(B) * S * 2 * N;
  if (i < nbc) {
    const int64_t row = i / (2 * N);
    const int col = static_cast<int>(i % (2 * N));
    const int b = static_cast<int>(row / S), t = static_cast<int>(row % S);
    const float* p = ws + (static_cast<int64_t>(b) * ncl * Sp + t) * 2 * N + col;
    float s = 0.f;
    for (int cl = 0; cl < ncl; ++cl) s += p[static_cast<int64_t>(cl) * Sp * 2 * N];
    if (col < N) dB[row * N + col] = s;
    else dC[row * N + col - N] = s;
  } else if (i < nbc + static_cast<int64_t>(di) * N) {
    const int64_t j = i - nbc;
    float s = 0.f;
    for (int b = 0; b < B; ++b) s += ws_a[static_cast<int64_t>(b) * di * N + j];
    dA[j] = s;
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

// Blocks of channels of one batch row.
int blocks(int di, int N, int R) {
  const int ch = THREADS * R / N;
  return (di + ch - 1) / ch;
}

// The blocks of a cluster: the largest power of two up to 8 and up to the
// blocks of a batch row.
int cluster_size(int nblk) {
  int cl = 1;
  while (cl * 2 <= MAX_CLUSTER && cl * 2 <= nblk) cl *= 2;
  return cl;
}

// States a thread: 4 where R 4's blocks give at least 90% of the SMs two
// each (R 4 spends fewer instructions a state-step), else 2: twice the
// blocks, where R 4 would leave many SMs one block of 4 warps.
int choose_r(int B, int di, int N) {
  const int sms = sm_count();
  return sms > 0 && 10 * static_cast<int64_t>(B) * blocks(di, N, 4) < 18 * static_cast<int64_t>(sms)
             ? 2 : 4;
}

template <typename TX, int N, int R>
constexpr int smem_bytes() { return static_cast<int>(sizeof(Smem<TX, N, R>)); }

template <typename TX, int N, int R>
int launch(const Args& a, int B, int cl, cudaStream_t stream) {
  constexpr int SMEM = smem_bytes<TX, N, R>();
  static const cudaError_t attr_rc = cudaFuncSetAttribute(
      ssm_scan_bwd_kernel<TX, N, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr_rc != cudaSuccess) return static_cast<int>(attr_rc);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.ncl * cl, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, ssm_scan_bwd_kernel<TX, N, R>, a));
}

// The kernel of (x dtype, N, R): its shared memory and the CTAs an SM
// holds.
template <typename TX, int N, int R>
int config(int* out) {
  constexpr int SMEM = smem_bytes<TX, N, R>();
  cudaError_t rc = cudaFuncSetAttribute(ssm_scan_bwd_kernel<TX, N, R>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  int per_sm = 0;
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ssm_scan_bwd_kernel<TX, N, R>, THREADS, SMEM);
  out[0] = SMEM;
  out[1] = per_sm;
  return static_cast<int>(rc);
}

// The kernel of (x dtype, N, R) launched on a, or (a null) its config.
template <typename TX>
int dispatch(int N, int R, const Args* a, int B, int cl, cudaStream_t st, int* out) {
#define SSM_BWD_CASE(NN, RR)                                                   \
  if (N == NN && R == RR)                                                      \
    return a ? launch<TX, NN, RR>(*a, B, cl, st) : config<TX, NN, RR>(out);
  SSM_BWD_CASE(16, 2)
  SSM_BWD_CASE(16, 4)
  SSM_BWD_CASE(8, 2)
  SSM_BWD_CASE(8, 4)
#undef SSM_BWD_CASE
  return -1;
}

int dispatch_all(int x_dtype, int N, int R, const Args* a, int B, int cl, cudaStream_t st,
                 int* out) {
  if (x_dtype == 0) return dispatch<float>(N, R, a, B, cl, st, out);
  if (x_dtype == 1) return dispatch<__nv_bfloat16>(N, R, a, B, cl, st, out);
  return -1;
}

}  // namespace

// The states per thread the backward takes for these sizes on this card.
extern "C" int ssm_scan_bwd_states(int B, int di, int N) { return choose_r(B, di, N); }

// Floats of the workspace ssm_scan_bwd needs at these sizes (R 0: its own
// choice): the clusters' dB | dC rows, then the batch rows' dA.
extern "C" int64_t ssm_scan_bwd_workspace(int B, int S, int di, int N, int R) {
  if (R == 0) R = choose_r(B, di, N);
  const int nblk = blocks(di, N, R), cl = cluster_size(nblk);
  const int64_t ncl = (nblk + cl - 1) / cl;
  const int64_t sp = static_cast<int64_t>((S + SAVED - 1) / SAVED) * SAVED;
  return B * ncl * sp * 2 * N + static_cast<int64_t>(B) * di * N;
}

// The design the backward runs at these sizes: out[0..6] = R, steps a
// sub-chunk, blocks a cluster, clusters a batch row, shared memory a CTA
// (bytes), CTAs an SM, CTAs of the grid. Returns 0, a cudaError_t or -1.
extern "C" int ssm_scan_bwd_config(int x_dtype, int B, int di, int N, int R, int* out) {
  if (R == 0) R = choose_r(B, di, N);
  const int nblk = blocks(di, N, R), cl = cluster_size(nblk), ncl = (nblk + cl - 1) / cl;
  int occ[2] = {0, 0};
  const int rc = dispatch_all(x_dtype, N, R, nullptr, B, cl, nullptr, occ);
  out[0] = R;
  out[1] = 32 / R;
  out[2] = cl;
  out[3] = ncl;
  out[4] = occ[0];
  out[5] = occ[1];
  out[6] = B * ncl * cl;
  return rc;
}

// dt, bm, cm, A, hs, dy, dh_final, ddt, dB, dC, dA, dh0: float32; x and dx:
// float32 (x_dtype 0) or bfloat16 (x_dtype 1). dt, x, dy: logical (B, S,
// di) with (batch, step) element strides; bm, cm: logical (B, S, N) with
// (batch, step) strides; the last dimension contiguous everywhere. A (di,
// N); hs (B, ceil(S / chunk), di, N), as ssm_scan_fwd writes it, where
// chunk must be SAVED; dh_final (B, di, N) or null. Outputs, contiguous:
// ddt and dx (B, S, di), dB and dC (B, S, N), dA (di, N), dh0 (B, di, N).
// work: ssm_scan_bwd_workspace(B, S, di, N, R) floats. R: 2 or 4,
// or 0 for ssm_scan_bwd_states' choice. Two kernels on one stream, the
// first a cluster launch. Returns 0, a cudaError_t, or -1 for arguments
// the kernels do not take.
extern "C" int ssm_scan_bwd(int x_dtype, const void* dt, const void* x, const void* bm,
                            const void* cm, const void* A, const void* hs, const void* dy,
                            const void* dh_final, void* ddt, void* dx, void* dB, void* dC,
                            void* dA, void* dh0, void* work, int chunk, int B, int S, int di,
                            int N, int64_t dt_sb, int64_t dt_ss, int64_t x_sb, int64_t x_ss,
                            int64_t b_sb, int64_t b_ss, int64_t c_sb, int64_t c_ss,
                            int64_t dy_sb, int64_t dy_ss, int R, void* stream) {
  if (B <= 0 || S <= 0 || di <= 0 || B > 65535 || chunk != SAVED ||
      (x_dtype != 0 && x_dtype != 1))
    return -1;
  if (R == 0) R = choose_r(B, di, N);
  Args a;
  a.dt = static_cast<const float*>(dt);
  a.x = x;
  a.bm = static_cast<const float*>(bm);
  a.cm = static_cast<const float*>(cm);
  a.A = static_cast<const float*>(A);
  a.hs = static_cast<const float*>(hs);
  a.dy = static_cast<const float*>(dy);
  a.dh_final = static_cast<const float*>(dh_final);
  a.ddt = static_cast<float*>(ddt);
  a.dx = dx;
  a.dh0 = static_cast<float*>(dh0);
  a.dt_sb = dt_sb; a.dt_ss = dt_ss; a.x_sb = x_sb; a.x_ss = x_ss;
  a.b_sb = b_sb; a.b_ss = b_ss; a.c_sb = c_sb; a.c_ss = c_ss;
  a.dy_sb = dy_sb; a.dy_ss = dy_ss;
  a.S = S; a.di = di; a.nc = (S + SAVED - 1) / SAVED;
  const int nblk = blocks(di, N, R), cl = cluster_size(nblk);
  a.ncl = (nblk + cl - 1) / cl;
  const int xe = x_dtype == 1 ? 2 : 4;   // bytes per element of x
  // base and row strides of a (., ., 4-element quad) layout aligned to quad bytes
  auto rows = [](const void* p, int64_t sb, int64_t ss, int elem, int quad) {
    return reinterpret_cast<uintptr_t>(p) % quad == 0 && (sb * elem) % quad == 0 &&
           (ss * elem) % quad == 0;
  };
  a.vec = di % 4 == 0 && rows(dt, dt_sb, dt_ss, 4, 16) && rows(x, x_sb, x_ss, xe, 4 * xe) &&
          rows(dy, dy_sb, dy_ss, 4, 16) && rows(bm, b_sb, b_ss, 4, 16) &&
          rows(cm, c_sb, c_ss, 4, 16) && rows(ddt, 0, di, 4, 16) && rows(dx, 0, di, xe, 4 * xe);
  const int64_t rows_ws = static_cast<int64_t>(B) * a.ncl * a.nc * SAVED * 2 * N;
  a.ws = static_cast<float*>(work);
  a.ws_a = a.ws + rows_ws;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = dispatch_all(x_dtype, N, R, &a, B, cl, st, nullptr);
  if (rc != 0) return rc;
  const int64_t total = static_cast<int64_t>(B) * S * 2 * N + static_cast<int64_t>(di) * N;
  const int threads = 256;
  ssm_scan_bwd_sum_kernel<<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0,
                            st>>>(a.ws, a.ws_a, static_cast<float*>(dB), static_cast<float*>(dC),
                                  static_cast<float*>(dA), B, S, a.nc * SAVED, a.ncl, di, N);
  return static_cast<int>(cudaGetLastError());
}
