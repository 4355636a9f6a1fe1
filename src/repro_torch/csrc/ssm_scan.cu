// K5: the selective state-space scan (Hymba's Mamba heads), with state in
// and out, in model layout.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssm_scan/kernel.py::ssm_scan_bhspn
//   (body _ssm_kernel, wrapper ops.py::ssm_scan),
// and computes what a scan of the model's step
// repro/models/ssm.py::_ssm_step computes, plus the D skip, per (batch,
// SSM head) and time step t, with the state S (P x N) in float32:
//   decay = exp(dt_t * -exp(a_log[h]))
//   S     = S * decay + (dt_t x_t) B_t^T
//   y_t   = S C_t + d_skip[h] x_t
// Unlike the Pallas kernel it takes an initial state and writes the final
// one, because the hybrid block's serve cache holds this state; without
// a state (has_state = 0) it starts from S = 0 as the Pallas kernel does.
// It runs exactly S steps. It reads the model's layout as it is: x and y
// (B, S, Hs, P), dt (B, S, Hs), and B_t, C_t (B, S, N) shared by all
// heads, and forms the decay and the skip itself, where the Pallas wrapper
// folds x to (B*Hs, S, P), broadcasts B and C over the heads and adds the
// skip in passes of its own.
//
// What bounds it on the H100: bytes, by a little. Per step and state
// element it does about 5 flops (S * decay, + u B, S . C); at hymba-1.5b's
// prefill (B 4, S 1024, Hs 25, P 64, N 16) that is 0.53 GFLOP, 0.008 ms
// at the f32 CUDA-core peak, against 28 MB of x, y (bf16), dt, B, C and
// the state, 0.008 ms at 3.35 TB/s. Neither is in reach: the recurrence
// is sequential in t and only B * Hs * P * N = 102,400 state elements
// advance per step, so the kernel is bound by the latency of one step.
//
// Design. A CTA owns one (batch, head): P rows of S, each split over
// L = N / 4 neighbouring threads that hold four of the row's N state
// values in registers for the whole scan (one float4, which is also the
// unit in which the state is read and written, coalesced). The state's
// own chain is one FMA per step; y's dot over N is four FMAs and log2 L
// shuffles within the row's threads, off that chain. Steps are staged in
// chunks of T: a chunk's x rows, dt values and B, C rows are copied to
// shared memory with cp.async while the CTA computes the chunk before, so
// global latency is paid once per scan, not per step. Every thread
// recomputes its head's decay from dt (one exp), and the first thread of
// each row writes y_t in x's type.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 32;       // steps per staged chunk
constexpr int MAX_P = 64;   // rows of S per head (P % 16 == 0)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T_> __device__ __forceinline__ T_ from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x, y (B, S, Hs, P) of TX; dt (B, S, Hs) f32; a_log, d_skip (Hs,) of TW;
// b, c (B, S, N) f32; state0, state (B, Hs, P, N) f32.
template <typename TX, typename TW, int N>
__global__ void __launch_bounds__(MAX_P * N / 4)
    ssm_scan_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                    const TW* __restrict__ a_log,
                    const float* __restrict__ bm,
                    const float* __restrict__ cm,
                    const TW* __restrict__ d_skip,
                    const float* __restrict__ state0, TX* __restrict__ y,
                    float* __restrict__ state, int S, int Hs, int P,
                    int has_state) {
  constexpr int L = N / 4;                  // threads per row of S
  constexpr int XV = 16 / sizeof(TX);       // x elements per 16 bytes
  __shared__ __align__(16) TX xs[2][T][MAX_P];
  __shared__ __align__(16) float bs[2][T][N];
  __shared__ __align__(16) float cs[2][T][N];
  __shared__ float dts[2][T];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;                // P * L
  const int p = tid / L;
  const int j = tid - p * L;

  const size_t row = ((size_t)b * Hs + h) * P + p;   // row of S
  float4 s = has_state
                 ? *reinterpret_cast<const float4*>(state0 + row * N + 4 * j)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  const float A = -expf(to_f(a_log[h]));
  const float D = to_f(d_skip[h]);

  // token t of this (batch, head) in x / y, of this batch in dt / b / c
  const size_t tok0 = (size_t)b * S;
  const int qx = P / XV;                    // 16-byte pieces per x row

  auto stage = [&](int chunk, int buf) {
    const int t0 = chunk * T;
    const int n = min(T, S - t0);
    for (int i = tid; i < n * qx; i += nt) {
      const int t = i / qx;
      const int q = i - t * qx;
      __pipeline_memcpy_async(
          &xs[buf][t][q * XV],
          x + ((tok0 + t0 + t) * Hs + h) * P + q * XV, 16);
    }
    for (int i = tid; i < n * N / 4; i += nt) {
      __pipeline_memcpy_async(&bs[buf][0][0] + 4 * i,
                              bm + (tok0 + t0) * N + 4 * i, 16);
      __pipeline_memcpy_async(&cs[buf][0][0] + 4 * i,
                              cm + (tok0 + t0) * N + 4 * i, 16);
    }
    for (int i = tid; i < n; i += nt)
      __pipeline_memcpy_async(&dts[buf][i], dt + (tok0 + t0 + i) * Hs + h,
                              4);
    __pipeline_commit();
  };

  const int n_chunks = (S + T - 1) / T;
  stage(0, 0);
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int buf = chunk & 1;
    if (chunk + 1 < n_chunks) {
      stage(chunk + 1, buf ^ 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();

    const int t0 = chunk * T;
    const int n = min(T, S - t0);
    TX* yp = y + ((tok0 + t0) * Hs + h) * P + p;
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      const float dtv = dts[buf][t];
      const float xv = to_f(xs[buf][t][p]);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[buf][t][4 * j]);
      const float4 cv = *reinterpret_cast<const float4*>(&cs[buf][t][4 * j]);
      const float decay = expf(dtv * A);
      const float u = dtv * xv;
      s.x = fmaf(u, bv.x, s.x * decay);
      s.y = fmaf(u, bv.y, s.y * decay);
      s.z = fmaf(u, bv.z, s.z * decay);
      s.w = fmaf(u, bv.w, s.w * decay);
      float acc = s.x * cv.x;
      acc = fmaf(s.y, cv.y, acc);
      acc = fmaf(s.z, cv.z, acc);
      acc = fmaf(s.w, cv.w, acc);
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (j == 0) yp[(size_t)t * Hs * P] = from_f<TX>(fmaf(D, xv, acc));
    }
    __syncthreads();   // the next stage() overwrites this buffer
  }

  *reinterpret_cast<float4*>(state + row * N + 4 * j) = s;
}

template <typename TX, typename TW, int N>
cudaError_t launch(const void* x, const void* dt, const void* a_log,
                   const void* b, const void* c, const void* d_skip,
                   const void* state0, void* y, void* state, int B, int S,
                   int Hs, int P, int has_state, cudaStream_t stream) {
  ssm_scan_kernel<TX, TW, N><<<dim3(Hs, B), P * (N / 4), 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(dt),
      static_cast<const TW*>(a_log), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const TW*>(d_skip),
      static_cast<const float*>(state0), static_cast<TX*>(y),
      static_cast<float*>(state), S, Hs, P, has_state);
  return cudaGetLastError();
}

template <typename TX, typename TW>
cudaError_t launch_n(const void* x, const void* dt, const void* a_log,
                     const void* b, const void* c, const void* d_skip,
                     const void* state0, void* y, void* state, int B, int S,
                     int Hs, int P, int N, int has_state,
                     cudaStream_t stream) {
  if (N == 8)
    return launch<TX, TW, 8>(x, dt, a_log, b, c, d_skip, state0, y, state,
                             B, S, Hs, P, has_state, stream);
  if (N == 16)
    return launch<TX, TW, 16>(x, dt, a_log, b, c, d_skip, state0, y, state,
                              B, S, Hs, P, has_state, stream);
  return cudaErrorInvalidValue;
}

template <typename TX>
cudaError_t launch_w(int w_dtype, const void* x, const void* dt,
                     const void* a_log, const void* b, const void* c,
                     const void* d_skip, const void* state0, void* y,
                     void* state, int B, int S, int Hs, int P, int N,
                     int has_state, cudaStream_t stream) {
  if (w_dtype == 0)
    return launch_n<TX, float>(x, dt, a_log, b, c, d_skip, state0, y, state,
                               B, S, Hs, P, N, has_state, stream);
  if (w_dtype == 1)
    return launch_n<TX, __nv_bfloat16>(x, dt, a_log, b, c, d_skip, state0,
                                       y, state, B, S, Hs, P, N, has_state,
                                       stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// x, y (B, S, Hs, P) of type x_dtype (0 float32, 1 bfloat16); dt
// (B, S, Hs), b, c (B, S, N) and state0, state (B, Hs, P, N) float32;
// a_log, d_skip (Hs,) of type w_dtype. All contiguous, and x, b, c and
// the states 16-byte aligned. P a multiple of 16 up to 64, N 8 or 16.
// state0 is read only when has_state is 1 (and may be null otherwise).
extern "C" int ssm_scan_fwd(const void* x, const void* dt, const void* a_log,
                            const void* b, const void* c, const void* d_skip,
                            const void* state0, void* y, void* state,
                            int x_dtype, int w_dtype, int B, int S, int Hs,
                            int P, int N, int has_state, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || Hs < 1 || P < 16 || P > MAX_P ||
      P % 16 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return launch_w<float>(w_dtype, x, dt, a_log, b, c, d_skip, state0, y,
                           state, B, S, Hs, P, N, has_state, st);
  if (x_dtype == 1)
    return launch_w<__nv_bfloat16>(w_dtype, x, dt, a_log, b, c, d_skip,
                                   state0, y, state, B, S, Hs, P, N,
                                   has_state, st);
  return cudaErrorInvalidValue;
}
