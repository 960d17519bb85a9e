// Mamba-1 selective scan for Hopper (sm_90a), the port of the TPU kernel
// src/repro/kernels/ssm_scan/kernel.py::ssm_scan
// (body _ssm_kernel, wrapper ops.py::selective_scan, oracle ref.py::ssm_scan_ref).
//
// What it computes: for each (b, channel d, state n), in time order,
//   h_t = exp(dt_t * A[d, n]) * h_{t-1} + (dt_t * x_t) * B_t[n]
//   y_t[d] = sum_n h_t[n] * C_t[n]
// from h0, and writes y (B, S, di) and the final state h_S (B, di, N),
// all in f32 (x may come in bf16 and is widened on load).
//
// What bounds it on the H100: device memory. Each (b, t, d) reads dt
// (4 bytes) and x (2 or 4) and writes y (4), and does about 7 operations
// per state for N = 16 states: some 11 operations per byte, under the 20
// per byte at which the f32 cores would be the limit. B_t and C_t are
// shared by all channels. At the Falcon-Mamba serve shape (B=1,
// S=2048, di=8192, N=16, x in bf16) that is 169.6 MB, 0.051 ms at
// 3.35 TB/s, against 1.9 GFLOP of f32 work, 0.028 ms at 67 TFLOP/s.
//
// Design, against that bound: every input byte is read from device memory
// once and the (S, di, N) discretised tensors never leave registers.
// The Pallas grid's sequential chunk axis, which carries h in VMEM scratch,
// becomes a time loop inside the block with h in a register: N lanes per
// channel, one state each, so B * di * N threads (131,072 at the serve
// shape) cover the card at batch 1. A block owns 256 / N channels; per
// chunk of 64 steps it stages their dt and x with coalesced loads, and
// the chunk's B_t and C_t rows once for all its channels, in shared
// memory. The sum over n is a reduce-scatter across the channel's N lanes
// over N time steps at once (N - 1 shuffles per N steps instead of
// N log2 N), which leaves y_t of step t on lane t; y goes back through
// shared memory so the stores are coalesced too. B and C are read through
// their strides (on the model path they are column slices of one
// projection), and the ragged tail of S is masked, not padded: a masked
// step has dt = 0, so exp(0) = 1 and h passes through unchanged. Exact
// expf, no fast math, so the kernel agrees with the plain version to
// 1e-4. One block walks all of S, so at small B * di the card is not
// full: splitting S across blocks with a second pass that combines the
// chunk states is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int T = 64;                 // time steps per shared-memory chunk

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
  int64_t dt_sb, dt_ss, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, y_sb, y_ss;
  int S, di;
};

template <typename TX, int N>
__global__ void __launch_bounds__(THREADS) ssm_scan_kernel(Args a) {
  static_assert(T % N == 0 && 32 % N == 0, "N lanes per channel");
  constexpr int CH = THREADS / N;     // channels per block
  __shared__ float s_dt[T][CH], s_x[T][CH], s_y[T][CH + 1];
  __shared__ float s_b[T][N], s_c[T][N];

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int n = threadIdx.x % N;
  const int ch = threadIdx.x / N;
  const int d = d0 + ch;
  const bool active = d < a.di;
  const int64_t h_at = ((int64_t)b * a.di + d) * N + n;
  const float An = active ? a.A[(int64_t)d * N + n] : 0.f;
  float h = active ? a.h0[h_at] : 0.f;

  const float* dt = a.dt + b * a.dt_sb;
  const TX* x = static_cast<const TX*>(a.x) + b * a.x_sb;
  const float* bm = a.bm + b * a.b_sb;
  const float* cm = a.cm + b * a.c_sb;
  float* y = a.y + b * a.y_sb;

  for (int t0 = 0; t0 < a.S; t0 += T) {
    for (int i = threadIdx.x; i < T * CH; i += THREADS) {
      const int tt = i / CH, c = i % CH, t = t0 + tt, dd = d0 + c;
      const bool in = t < a.S && dd < a.di;
      s_dt[tt][c] = in ? dt[t * a.dt_ss + dd] : 0.f;
      s_x[tt][c] = in ? to_f32(x[t * a.x_ss + dd]) : 0.f;
    }
    for (int i = threadIdx.x; i < T * N; i += THREADS) {
      const int tt = i / N, k = i % N, t = t0 + tt;
      const bool in = t < a.S;
      s_b[tt][k] = in ? bm[t * a.b_ss + k] : 0.f;
      s_c[tt][k] = in ? cm[t * a.c_ss + k] : 0.f;
    }
    __syncthreads();

    for (int g = 0; g < T; g += N) {
      float p[N];                     // h_t[n] * C_t[n] for t = g .. g + N - 1
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float dtv = s_dt[g + j][ch];
        const float da = expf(dtv * An);
        h = fmaf(h, da, dtv * s_x[g + j][ch] * s_b[g + j][n]);
        p[j] = h * s_c[g + j][n];
      }
      // reduce-scatter over the channel's N lanes: after the round at
      // offset w a lane keeps the half of its steps whose bit w equals
      // its own, summed with its partner's; at the end lane n holds the
      // whole sum for step g + n
#pragma unroll
      for (int w = N / 2; w >= 1; w >>= 1) {
        const bool upper = (n & w) != 0;
#pragma unroll
        for (int j = 0; j < w; ++j) {
          const float send = upper ? p[j] : p[j + w];
          const float keep = upper ? p[j + w] : p[j];
          p[j] = keep + __shfl_xor_sync(0xffffffffu, send, w);
        }
      }
      s_y[g + n][ch] = p[0];
    }
    __syncthreads();

    for (int i = threadIdx.x; i < T * CH; i += THREADS) {
      const int tt = i / CH, c = i % CH, t = t0 + tt, dd = d0 + c;
      if (t < a.S && dd < a.di) y[t * a.y_ss + dd] = s_y[tt][c];
    }
    // the next chunk's loads write only s_dt, s_x, s_b and s_c, and s_y
    // is written again only after the next __syncthreads
  }
  if (active) a.h_final[h_at] = h;
}

template <typename TX, int N>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int CH = THREADS / N;
  const dim3 grid((a.di + CH - 1) / CH, B);
  ssm_scan_kernel<TX, N><<<grid, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename TX>
int dispatch_n(int N, const Args& a, int B, cudaStream_t st) {
  switch (N) {
    case 8: return launch<TX, 8>(a, B, st);
    case 16: return launch<TX, 16>(a, B, st);
    default: return -1;
  }
}

}  // namespace

// dt, Bm, Cm, A, h0, y, h_final: float32; x: float32 (x_dtype 0) or
// bfloat16 (x_dtype 1). dt, x, y: logical (B, S, di) with (batch, step)
// element strides; Bm, Cm: logical (B, S, N) with (batch, step) strides;
// the last dimension contiguous everywhere. A (di, N), h0 and h_final
// (B, di, N): contiguous. Returns 0, a cudaError_t, or -1 for arguments
// the kernel does not take (N other than 8 or 16).
extern "C" int ssm_scan_fwd(int x_dtype, const void* dt, const void* x, const void* bm,
                            const void* cm, const void* A, const void* h0, void* y,
                            void* h_final, int B, int S, int di, int N,
                            int64_t dt_sb, int64_t dt_ss, int64_t x_sb, int64_t x_ss,
                            int64_t b_sb, int64_t b_ss, int64_t c_sb, int64_t c_ss,
                            int64_t y_sb, int64_t y_ss, void* stream) {
  if (B <= 0 || S < 0 || di <= 0 || B > 65535) return -1;
  Args a;
  a.dt = static_cast<const float*>(dt);
  a.x = x;
  a.bm = static_cast<const float*>(bm);
  a.cm = static_cast<const float*>(cm);
  a.A = static_cast<const float*>(A);
  a.h0 = static_cast<const float*>(h0);
  a.y = static_cast<float*>(y);
  a.h_final = static_cast<float*>(h_final);
  a.dt_sb = dt_sb; a.dt_ss = dt_ss; a.x_sb = x_sb; a.x_ss = x_ss;
  a.b_sb = b_sb; a.b_ss = b_ss; a.c_sb = c_sb; a.c_ss = c_ss;
  a.y_sb = y_sb; a.y_ss = y_ss;
  a.S = S; a.di = di;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return dispatch_n<float>(N, a, B, st);
  if (x_dtype == 1) return dispatch_n<__nv_bfloat16>(N, a, B, st);
  return -1;
}
