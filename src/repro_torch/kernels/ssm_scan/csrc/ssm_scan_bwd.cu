// The selective scan's backward for Hopper (sm_90a). No TPU kernel: it
// replaces XLA's autodiff of src/repro/models/mamba.py:53
// (ssm_scan_chunked), through which the reference trains; its Pallas
// kernel (src/repro/kernels/ssm_scan/kernel.py:67) has no VJP. Wrapper
// ops.py::selective_scan_bwd, oracle ref.py::ssm_scan_ref_bwd.
//
// What it computes: with the forward's a_t = exp(dt_t A[d, n]),
// b_t = dt_t x_t B_t[n], h_t = a_t h_{t-1} + b_t, y_t[d] = sum_n h_t C_t[n],
// and g_t = dL/dh_t = dy_t C_t + a_{t+1} g_{t+1} (g_S adds dh_final):
//   dC_t[n] = sum_d dy_t h_t             dB_t[n] = sum_d g_t dt_t x_t
//   d(dt)_t[d] = sum_n g_t (A a_t h_{t-1} + x_t B_t[n])
//   dx_t[d] = sum_n g_t dt_t B_t[n]      dA[d, n] = sum_{b,t} g_t dt_t a_t h_{t-1}
//   dh0 = a_1 g_1
// all in f32; dx is written in x's dtype (bf16 on the model path).
//
// What bounds it on the H100: per state and step two exponentials (the
// decay is computed once in the recompute and once in the reverse walk;
// one MUFU.EX2 each, 16 a clock per SM) and about twenty f32 operations;
// per (b, t, d) it reads dt, x, dy and writes d(dt), dx, and it reads one
// saved state per chunk. At falcon-mamba-7b's training shape (B 2 x S 4096
// x di 8192 x N 16, 1.07e9 state-steps) the exponentials alone are about
// 0.5 ms on the special-function units, the bytes about 0.4 ms.
//
// Design, simple and deterministic:
// * One CTA per (batch row, block of CH channels), each thread one channel
//   and R of its N states (the forward's layout, R from the same rule). The
//   CTA walks chunks of CHUNK steps from last to first. For each chunk it
//   stages dt, x, dy, B and C in shared memory, recomputes the chunk's
//   states forward from the state the forward kernel saved at the chunk's
//   start (hs, its STATES flag), with the forward's own operations, into
//   shared memory, then walks the chunk backwards carrying a_{t+1} g_{t+1}
//   in registers. A state is never rebuilt by dividing by a decay.
// * Sums over the N states of a channel (d(dt), dx) are per thread, then
//   over the channel's G = N / R lanes by a butterfly of shuffles. Sums
//   over channels (dB, dC) go by a reduce-scatter over the W = 32 / G
//   channels of a warp (the forward's butterfly, over channels instead of
//   steps), then over the CTA's warps in order through shared memory, into
//   a workspace of one row per (batch row, block, step). A second kernel
//   adds the blocks' rows in block order, and the batch rows' dA in order.
//   No float atomics: two runs give the same bits.
// * The decays use ex2.approx.ftz on A log2(e), as the forward; the
//   derivatives of exp(dt A) are in natural units (A a, dt a), so log2(e)
//   enters no gradient.
// * The ragged tail of S and of di is masked, as in the forward: a masked
//   step has dt = x = dy = B = C = 0, so its decay is 1, g passes through,
//   it adds nothing to dA, dB or dC, and its d(dt) and dx are not written.
// * Loads and stores are plain (no alignment is assumed); B and C are read
//   through their strides (column views of one projection on the model
//   path).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 32;             // steps a chunk: the forward's state interval
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

struct Args {
  const float* dt;        // logical (B, S, di): strides dt_sb, dt_ss
  const void* x;          // logical (B, S, di): strides x_sb, x_ss
  const float* bm;        // logical (B, S, N): strides b_sb, b_ss
  const float* cm;        // logical (B, S, N): strides c_sb, c_ss
  const float* A;         // (di, N), contiguous
  const float* hs;        // (B, nc, di, N): the forward's chunk-boundary states
  const float* dy;        // logical (B, S, di): strides dy_sb, dy_ss
  const float* dh_final;  // (B, di, N) or null (zero)
  float* ddt;             // (B, S, di), contiguous
  void* dx;               // (B, S, di) in x's dtype, contiguous
  float* ws;              // (B, nblk, nc * CHUNK, 2N): each block's dB | dC rows
  float* ws_a;            // (B, di, N): each batch row's dA
  float* dh0;             // (B, di, N)
  int64_t dt_sb, dt_ss, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, dy_sb, dy_ss;
  int S, di, nc, nblk;
};

template <int N, int R>
struct Shape {
  static_assert(N % R == 0 && R >= 2, "R divides N");
  static constexpr int G = N / R;                   // lanes a channel
  static constexpr int CH = THREADS / G;            // channels a block
  static constexpr int W = 32 / G;                  // channels a warp
  static constexpr int LQ = CHUNK * CH / THREADS;   // (step, channel) pairs a thread stages
  static constexpr int LB = (CHUNK * N + THREADS - 1) / THREADS;
  static constexpr int LP = CHUNK * 2 * N / THREADS;   // dB | dC sums a thread writes
  static_assert(LQ >= 1 && LP >= 1 && 32 % G == 0, "whole warps of channels");
};

template <int N, int R>
struct __align__(16) Smem {
  static constexpr int CH = Shape<N, R>::CH;
  float h[CHUNK + 1][THREADS * R];   // row 0: the state entering the chunk; row t + 1: h_t
  float dt[CHUNK][CH];
  float x[CHUNK][CH];
  float dy[CHUNK][CH];
  float ddt[CHUNK][CH];
  float dx[CHUNK][CH];
  float b[CHUNK][N];
  float c[CHUNK][N];
  float part[WARPS][CHUNK][2 * N];   // each warp's dB | dC at each step
};

template <int R>
__device__ __forceinline__ void ld_row(float (&v)[R], const float* p) {
#pragma unroll
  for (int q = 0; q < R; q += 2) {
    const float2 f = reinterpret_cast<const float2*>(p)[q / 2];
    v[q] = f.x; v[q + 1] = f.y;
  }
}
template <int R>
__device__ __forceinline__ void st_row(float* p, const float (&v)[R]) {
#pragma unroll
  for (int q = 0; q < R; q += 2) reinterpret_cast<float2*>(p)[q / 2] = make_float2(v[q], v[q + 1]);
}

// Grid (nblk, B): the block's CH channels of batch row b, chunk by chunk
// from the last.
template <typename TX, int N, int R>
__global__ void __launch_bounds__(THREADS) ssm_scan_bwd_kernel(Args a) {
  using SH = Shape<N, R>;
  constexpr int G = SH::G, CH = SH::CH, W = SH::W, M = 2 * R, LW = ilog2(W);
  extern __shared__ __align__(16) unsigned char smem[];
  Smem<N, R>& sm = *reinterpret_cast<Smem<N, R>*>(smem);
  const int tid = threadIdx.x, ch = tid / G, k = tid % G;
  const int lane = tid % 32, warp = tid / 32, cw = lane / G;   // cw: channel in the warp
  const int b = blockIdx.y, blk = blockIdx.x;
  const int d0 = blk * CH, d = d0 + ch;
  const bool active = d < a.di;
  const int64_t h_at = (static_cast<int64_t>(b) * a.di + d) * N + k * R;
  const int S = a.S, Sp = a.nc * CHUNK;

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
  float* wsp = a.ws + (static_cast<int64_t>(b) * a.nblk + blk) * Sp * 2 * N;

  for (int c = a.nc - 1; c >= 0; --c) {
    const int t0 = c * CHUNK;
    // the chunk's inputs, zeros outside S and di
#pragma unroll
    for (int j = 0; j < SH::LQ; ++j) {
      const int i = tid + j * THREADS, tt = i / CH, cc = i % CH;
      const int t = t0 + tt, dd = d0 + cc;
      const bool in = t < S && dd < a.di;
      sm.dt[tt][cc] = in ? dtp[t * a.dt_ss + dd] : 0.f;
      sm.x[tt][cc] = in ? to_f32(xp[t * a.x_ss + dd]) : 0.f;
      sm.dy[tt][cc] = in ? dyp[t * a.dy_ss + dd] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < SH::LB; ++j) {
      const int i = tid + j * THREADS;
      if (i < CHUNK * N) {
        const int tt = i / N, n = i % N, t = t0 + tt;
        sm.b[tt][n] = t < S ? bp[t * a.b_ss + n] : 0.f;
        sm.c[tt][n] = t < S ? cp[t * a.c_ss + n] : 0.f;
      }
    }
    float h[R];
    const int64_t hs_at = ((static_cast<int64_t>(b) * a.nc + c) * a.di + d) * N + k * R;
#pragma unroll
    for (int j = 0; j < R; ++j) h[j] = active ? a.hs[hs_at + j] : 0.f;
    __syncthreads();

    // The chunk's states, forward from the saved one, with the forward
    // kernel's operations: u = (dt x) B, h = fma(h, exp2(dt A log2 e), u).
    // Each thread writes and reads only its own slots of sm.h.
    float* hrow = &sm.h[0][tid * R];
    st_row(hrow, h);
    for (int t = 0; t < CHUNK; ++t) {
      const float dtv = sm.dt[t][ch], dtx = dtv * sm.x[t][ch];
#pragma unroll
      for (int j = 0; j < R; ++j) h[j] = fmaf(h[j], decay(dtv, A2[j]), dtx * sm.b[t][k * R + j]);
      st_row(hrow + (t + 1) * THREADS * R, h);
    }

    // The reverse walk: h holds h_t, each step reads h_{t-1}.
    for (int t = CHUNK - 1; t >= 0; --t) {
      const float dtv = sm.dt[t][ch], xv = sm.x[t][ch], dyv = sm.dy[t][ch];
      const float dtx = dtv * xv;
      float hp[R], v[M];             // v: this thread's dB_t (first R) and dC_t (last R)
      ld_row(hp, hrow + t * THREADS * R);
      float sdx = 0.f, sddt = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float bv = sm.b[t][k * R + j], cv = sm.c[t][k * R + j];
        const float da = decay(dtv, A2[j]);
        const float g = fmaf(dyv, cv, carry[j]);
        const float ah = da * hp[j];                  // a_t h_{t-1}
        v[j] = g * dtx;
        v[R + j] = dyv * h[j];
        sdx = fmaf(g, bv, sdx);
        sddt = fmaf(g, fmaf(An[j], ah, xv * bv), sddt);
        dA[j] = fmaf(g * dtv, ah, dA[j]);
        carry[j] = da * g;
        h[j] = hp[j];
      }
      // the channel's sums over its G lanes
#pragma unroll
      for (int w = 1; w < G; w <<= 1) {
        sdx += __shfl_xor_sync(FULL, sdx, w);
        sddt += __shfl_xor_sync(FULL, sddt, w);
      }
      if (k == 0) {
        sm.ddt[t][ch] = sddt;
        sm.dx[t][ch] = sdx * dtv;
      }
      // dB_t and dC_t over the warp's W channels: a reduce-scatter from the
      // top bit of the channel down, keeping halves while there are values
      // to split, then adding. Lane (cw, k) ends with the values v[base ..
      // base + M / W) (or, where M < W, one value shared by W / M lanes).
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
          sm.part[warp][t][col] = v[j];
        }
      }
    }
    __syncthreads();
    // the chunk's d(dt) and dx, coalesced; the block's dB | dC rows, its
    // warps added in order
#pragma unroll
    for (int j = 0; j < SH::LQ; ++j) {
      const int i = tid + j * THREADS, tt = i / CH, cc = i % CH;
      const int t = t0 + tt, dd = d0 + cc;
      if (t < S && dd < a.di) {
        ddtp[static_cast<int64_t>(t) * a.di + dd] = sm.ddt[tt][cc];
        dxp[static_cast<int64_t>(t) * a.di + dd] = from_f32<TX>(sm.dx[tt][cc]);
      }
    }
#pragma unroll
    for (int j = 0; j < SH::LP; ++j) {
      const int i = tid + j * THREADS, tt = i / (2 * N), col = i % (2 * N);
      float s = sm.part[0][tt][col];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) s += sm.part[w][tt][col];
      wsp[static_cast<int64_t>(t0 + tt) * 2 * N + col] = s;
    }
    // the next chunk's staging writes arrays this pass does not read, and
    // its walk writes these only after the barrier that follows staging
  }
  if (active) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      a.ws_a[h_at + j] = dA[j];
      a.dh0[h_at + j] = carry[j];
    }
  }
}

// dB and dC: each (b, t, n) the sum of the blocks' rows in block order;
// dA: each (d, n) the sum of the batch rows' in batch order.
__global__ void ssm_scan_bwd_sum_kernel(const float* ws, const float* ws_a, float* dB,
                                        float* dC, float* dA, int B, int S, int Sp, int nblk,
                                        int di, int N) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t nbc = static_cast<int64_t>(B) * S * 2 * N;
  if (i < nbc) {
    const int64_t row = i / (2 * N);
    const int col = static_cast<int>(i % (2 * N));
    const int b = static_cast<int>(row / S), t = static_cast<int>(row % S);
    const float* p = ws + (static_cast<int64_t>(b) * nblk * Sp + t) * 2 * N + col;
    float s = 0.f;
    for (int blk = 0; blk < nblk; ++blk) s += p[static_cast<int64_t>(blk) * Sp * 2 * N];
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

int64_t blocks(int B, int di, int N, int R) {
  const int ch = THREADS * R / N;
  return static_cast<int64_t>(B) * ((di + ch - 1) / ch);
}

// The forward's rule (ssm_scan.cu choose_r): 4 states a thread where that
// still gives every SM a block, else 2.
int choose_r(int B, int di, int N) {
  const int sms = sm_count();
  return sms > 0 && blocks(B, di, N, 4) < sms ? 2 : 4;
}

template <typename TX, int N, int R>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int SMEM = sizeof(Smem<N, R>);
  static const cudaError_t attr_rc = cudaFuncSetAttribute(
      ssm_scan_bwd_kernel<TX, N, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr_rc != cudaSuccess) return static_cast<int>(attr_rc);
  ssm_scan_bwd_kernel<TX, N, R><<<dim3(a.nblk, B), THREADS, SMEM, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX>
int dispatch(int N, int R, const Args& a, int B, cudaStream_t st) {
  if (N == 16 && R == 2) return launch<TX, 16, 2>(a, B, st);
  if (N == 16 && R == 4) return launch<TX, 16, 4>(a, B, st);
  if (N == 8 && R == 2) return launch<TX, 8, 2>(a, B, st);
  if (N == 8 && R == 4) return launch<TX, 8, 4>(a, B, st);
  return -1;
}

}  // namespace

// The states per thread the backward takes for these sizes on this card.
extern "C" int ssm_scan_bwd_states(int B, int di, int N) { return choose_r(B, di, N); }

// Floats of the workspace ssm_scan_bwd needs at these sizes (R 0: its own
// choice): the blocks' dB | dC rows, then the batch rows' dA.
extern "C" int64_t ssm_scan_bwd_workspace(int B, int S, int di, int N, int R) {
  if (R == 0) R = choose_r(B, di, N);
  const int64_t nblk = blocks(1, di, N, R);
  const int64_t sp = static_cast<int64_t>((S + CHUNK - 1) / CHUNK) * CHUNK;
  return B * nblk * sp * 2 * N + static_cast<int64_t>(B) * di * N;
}

// dt, bm, cm, A, hs, dy, dh_final, ddt, dB, dC, dA, dh0: float32; x and dx:
// float32 (x_dtype 0) or bfloat16 (x_dtype 1). dt, x, dy: logical (B, S,
// di) with (batch, step) element strides; bm, cm: logical (B, S, N) with
// (batch, step) strides; the last dimension contiguous everywhere. A (di,
// N); hs (B, ceil(S / chunk), di, N), as ssm_scan_fwd writes it, where
// chunk must be CHUNK; dh_final (B, di, N) or null. Outputs, contiguous:
// ddt and dx (B, S, di), dB and dC (B, S, N), dA (di, N), dh0 (B, di, N).
// work: ssm_scan_bwd_workspace(B, S, di, N, R) floats. R: 2 or 4, or 0
// for ssm_scan_bwd_states' choice. Two kernels on one stream. Returns 0,
// a cudaError_t, or -1 for arguments the kernels do not take.
extern "C" int ssm_scan_bwd(int x_dtype, const void* dt, const void* x, const void* bm,
                            const void* cm, const void* A, const void* hs, const void* dy,
                            const void* dh_final, void* ddt, void* dx, void* dB, void* dC,
                            void* dA, void* dh0, void* work, int chunk, int B, int S, int di,
                            int N, int64_t dt_sb, int64_t dt_ss, int64_t x_sb, int64_t x_ss,
                            int64_t b_sb, int64_t b_ss, int64_t c_sb, int64_t c_ss,
                            int64_t dy_sb, int64_t dy_ss, int R, void* stream) {
  if (B <= 0 || S <= 0 || di <= 0 || B > 65535 || chunk != CHUNK || (x_dtype != 0 && x_dtype != 1))
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
  a.S = S; a.di = di; a.nc = (S + CHUNK - 1) / CHUNK;
  a.nblk = static_cast<int>(blocks(1, di, N, R));
  const int64_t rows = static_cast<int64_t>(B) * a.nblk * a.nc * CHUNK * 2 * N;
  a.ws = static_cast<float*>(work);
  a.ws_a = a.ws + rows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = x_dtype == 0 ? dispatch<float>(N, R, a, B, st)
                              : dispatch<__nv_bfloat16>(N, R, a, B, st);
  if (rc != 0) return rc;
  const int64_t total = static_cast<int64_t>(B) * S * 2 * N + static_cast<int64_t>(di) * N;
  const int threads = 256;
  ssm_scan_bwd_sum_kernel<<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0,
                            st>>>(a.ws, a.ws_a, static_cast<float*>(dB), static_cast<float*>(dC),
                                  static_cast<float*>(dA), B, S, a.nc * CHUNK, a.nblk, di, N);
  return static_cast<int>(cudaGetLastError());
}
