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
// Two paths, chosen by S. From CL steps up (prefill) the chunked form
// below runs; under CL steps (decode is S = 1) the step kernel runs the
// recurrence as written.
//
// What bounds it on the H100: bytes, by a little. Per step and state
// element it does about 5 flops (S * decay, + u B, S . C); at hymba-1.5b's
// prefill (B 4, S 1024, Hs 25, P 64, N 16) that is 0.53 GFLOP, 0.008 ms
// at the f32 CUDA-core peak, against 28 MB of x, y (bf16), dt, B, C and
// the state, 0.008 ms at 3.35 TB/s. The step form reaches neither: the
// recurrence is sequential in t and only B * Hs * P * N = 102,400 state
// elements advance per step, so it is bound by the latency of one step;
// the chunked form makes all but a 32-step pass parallel.
//
// The step kernel. A CTA owns one (batch, head): P rows of S, each split
// over L = N / 4 neighbouring threads that hold four of the row's N state
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

#include "sm90_helpers.cuh"

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

// --- the chunked path (state-space duality) ---------------------------------
//
// For S >= CL steps the scan runs in chunks of CL steps. Per (batch, head)
// and chunk, with cum_t the sum of dt_s A over the chunk's steps up to t
// and S0 the state at the chunk's start:
//   y_t = sum_{s<=t} exp(cum_t - cum_s) (C_t . B_s) dt_s x_s
//         + exp(cum_t) S0 C_t + D x_t
//   S   = exp(cum_L) S0 + sum_s exp(cum_L - cum_s) dt_s x_s B_s^T
// with the exponent masked to s <= t before the exp (exp(+large) * 0 is
// NaN). The decay is one scalar per (batch, step, head) and B_t, C_t are
// shared by the heads, so C B^T is one CL x CL matrix per (batch, chunk).
//
// Three launches, the first and last parallel over (chunk, head, batch):
// ssd_chunk_state writes each chunk's own state increment
// sum_s exp(cum_L - cum_s) dt_s x_s B_s^T and its decay exp(cum_L);
// ssd_state_pass, one CTA per (head, batch), walks the chunks and turns
// each increment in place into the state at its chunk's start (a P x N
// FMA per chunk), and writes the final state; ssd_chunk_out computes
// C B^T once for HG heads and then each head's y, in x's type. At
// hymba-1.5b's prefill (B 4, S 1024, Hs 25, P 64, N 16) that is 3,200
// (chunk, head) tiles of work where the step kernel had 100 CTAs, and only
// the 32-step pass is sequential. The products (about 8.5 K flops per
// (batch, head, step)) run as mma.sync m16n8k8 tiles in 3xTF32, close to
// f32's accuracy.

constexpr int CL = 32;     // steps per chunk
constexpr int NT = 256;    // threads per CTA of the chunk kernels
constexpr int HG = 5;      // heads per CTA of the chunk kernels
constexpr int PASS = 8;    // chunks whose increments ssd_state_pass loads at once
constexpr int XP = MAX_P + 8;   // row stride (elements) of staged x: rows of
                                // 16-byte pieces, fragments in 32 banks

using repro_sm90::warp_mma;

// 16 (or 4) bytes global -> shared by cp.async; with ok false nothing is
// read and the bytes are zero-filled
__device__ __forceinline__ void copy16(void* dst, const void* src, bool ok) {
  __pipeline_memcpy_async(dst, src, 16, ok ? 0 : 16);
}
__device__ __forceinline__ void copy4(void* dst, const void* src, bool ok) {
  __pipeline_memcpy_async(dst, src, 4, ok ? 0 : 4);
}

// head h's rows t < n of the chunk of x into xs (zeros past n)
template <typename TX>
__device__ __forceinline__ void stage_x(TX (*xs)[XP],
                                        const TX* __restrict__ x,
                                        size_t tok0, int n, int Hs, int h,
                                        int P) {
  constexpr int XV = 16 / sizeof(TX);
  const int qx = P / XV;
  for (int i = threadIdx.x; i < CL * qx; i += blockDim.x) {
    const int t = i / qx;
    const int q = i - t * qx;
    const bool ok = t < n;
    copy16(&xs[t][q * XV], x + ((tok0 + (ok ? t : 0)) * Hs + h) * P + q * XV,
           ok);
  }
}

// head h's dt over the chunk (zeros past n)
__device__ __forceinline__ void stage_dt(float* dts,
                                         const float* __restrict__ dt,
                                         size_t tok0, int n, int Hs, int h) {
  for (int t = threadIdx.x; t < CL; t += blockDim.x) {
    const bool ok = t < n;
    copy4(&dts[t], dt + (tok0 + (ok ? t : 0)) * Hs + h, ok);
  }
}

// the chunk's rows of b (or c), CL x N floats from src into rows of
// stride RS floats (zeros past n)
template <int N, int RS>
__device__ __forceinline__ void stage_bc(float (*dst)[RS],
                                         const float* __restrict__ src,
                                         int n) {
  for (int i = threadIdx.x; i < CL * N / 4; i += blockDim.x) {
    const int s = i / (N / 4);
    const int kq = i - s * (N / 4);
    const bool ok = s < n;
    copy16(&dst[s][4 * kq], src + (ok ? 4 * i : 0), ok);
  }
}

// dt A summed over the chunk's steps in step order, as the plain version's
// cumsum (thread 0); steps past n keep the last sum
__device__ __forceinline__ void chunk_cum(const float* dts, float A, int n,
                                          float* cum) {
  if (threadIdx.x == 0) {
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < CL; ++t) {
      if (t < n) acc += dts[t] * A;
      cum[t] = acc;
    }
  }
}

// The two chunk kernels below walk the HG heads of their CTA in turn: the
// next head's x (and state, and dt) are staged by cp.async while this
// head computes, and the warps take the head's m16n8 output tiles in turn,
// each a product on the tensor cores in 3xTF32 (about f32's accuracy).

// x (B, S, Hs, P); dt (B, S, Hs); b (B, S, N); dS (B, Hs, nc, P, N) and
// dA (B, Hs, nc): each chunk's state increment and decay exp(cum_L).
// Grid (nc, ceil(Hs / HG), B), NT threads. Per head, the increment
// (P x N) = (wdt o X)^T B over k = the chunk's CL steps.
template <typename TX, typename TW, int N>
__global__ void __launch_bounds__(NT, 3)
    ssd_chunk_state(const TX* __restrict__ x, const float* __restrict__ dt,
                    const TW* __restrict__ a_log,
                    const float* __restrict__ bm, float* __restrict__ dS,
                    float* __restrict__ dA, int S, int Hs, int P, int nc) {
  constexpr int BS = N + 8;   // row stride of bs (B fragments: 32 banks)
  __shared__ __align__(16) TX xs[2][CL][XP];
  __shared__ __align__(16) float bs[CL][BS];
  __shared__ float dts[2][CL], cum[CL], wdt[CL], Ah[HG];
  const int c = blockIdx.x;
  const int b = blockIdx.z;
  const int h0 = blockIdx.y * HG;
  const int h1 = min(Hs, h0 + HG);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t0 = c * CL;
  const int n = min(CL, S - t0);
  const size_t tok0 = (size_t)b * S + t0;
  if (tid < h1 - h0) Ah[tid] = -expf(to_f(a_log[h0 + tid]));
  stage_bc<N, BS>(bs, bm + tok0 * N, n);
  stage_x(xs[0], x, tok0, n, Hs, h0, P);
  stage_dt(dts[0], dt, tok0, n, Hs, h0);
  __pipeline_commit();
  const int mt = P / 16;      // m16 tiles along p
  for (int h = h0; h < h1; ++h) {
    const int buf = (h - h0) & 1;
    if (h + 1 < h1) {
      stage_x(xs[buf ^ 1], x, tok0, n, Hs, h + 1, P);
      stage_dt(dts[buf ^ 1], dt, tok0, n, Hs, h + 1);
    }
    __pipeline_commit();
    __pipeline_wait_prior(1);   // this head's (and b's) copies landed
    __syncthreads();
    chunk_cum(dts[buf], Ah[h - h0], n, cum);
    __syncthreads();
    const float cL = cum[CL - 1];
    for (int t = tid; t < CL; t += NT)
      wdt[t] = t < n ? expf(cL - cum[t]) * dts[buf][t] : 0.f;
    const size_t bhc = ((size_t)b * Hs + h) * nc + c;
    if (tid == 0) dA[bhc] = expf(cL);
    __syncthreads();
    for (int tile = warp; tile < mt * (N / 8); tile += NT / 32) {
      const int p0 = 16 * (tile % mt);
      const int k0 = 8 * (tile / mt);
      float acc[1][4] = {{0.f, 0.f, 0.f, 0.f}};
      float cor[1][4] = {{0.f, 0.f, 0.f, 0.f}};
      warp_mma<1, CL>(
          acc, cor,
          [&](int row, int kk) {
            return wdt[kk] * to_f(xs[buf][kk][p0 + row]);
          },
          [&](int kk, int col) { return bs[kk][k0 + col]; }, lane);
      const int g = lane >> 2;
      const int q = lane & 3;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(dS + (bhc * P + p0 + g + 8 * r) * N + k0 +
                                   2 * q) =
            make_float2(acc[0][2 * r] + cor[0][2 * r],
                        acc[0][2 * r + 1] + cor[0][2 * r + 1]);
    }
    __syncthreads();   // the next head's staging reuses this head's buffers
  }
}

// Grid (Hs, B), P * N / 4 threads, each a float4 of the state: for each
// chunk, dS[c] <- the state at the chunk's start, state <- dA[c] state +
// the increment; the final state to `state`.
__global__ void ssd_state_pass(const float* __restrict__ state0,
                               float* __restrict__ dS,
                               const float* __restrict__ dA,
                               float* __restrict__ state, int Hs, int PN,
                               int nc, int has_state) {
  const size_t bh = (size_t)blockIdx.y * Hs + blockIdx.x;
  const int tid = threadIdx.x;
  float4 s = has_state
                 ? reinterpret_cast<const float4*>(state0 + bh * PN)[tid]
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  float4* d = reinterpret_cast<float4*>(dS + bh * nc * PN) + tid;
  const float* a = dA + bh * nc;
  const int stride = PN / 4;
  // PASS chunks at a time: their loads all in flight before the chain
  for (int c0 = 0; c0 < nc; c0 += PASS) {
    float4 inc[PASS];
    float g[PASS];
#pragma unroll
    for (int i = 0; i < PASS; ++i)
      if (c0 + i < nc) {
        inc[i] = d[(size_t)(c0 + i) * stride];
        g[i] = a[c0 + i];
      }
#pragma unroll
    for (int i = 0; i < PASS; ++i)
      if (c0 + i < nc) {
        d[(size_t)(c0 + i) * stride] = s;
        s.x = fmaf(g[i], s.x, inc[i].x);
        s.y = fmaf(g[i], s.y, inc[i].y);
        s.z = fmaf(g[i], s.z, inc[i].z);
        s.w = fmaf(g[i], s.w, inc[i].w);
      }
  }
  reinterpret_cast<float4*>(state + bh * PN)[tid] = s;
}

// a pair of y values of type TX
__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a,
                                       float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// x, y (B, S, Hs, P); dt (B, S, Hs); b, c (B, S, N); Sc (B, Hs, nc, P, N),
// the state at each chunk's start. Grid (nc, ceil(Hs / HG), B), NT
// threads. C B^T is formed once for the CTA's heads. Per head, y's CL x P
// block is (M X)_tile over k = the CL steps plus exp(cum_t) (C S0^T)_tile
// over k = N, tile by tile; the D skip and the cast to x's type in the
// epilogue.
template <typename TX, typename TW, int N>
__global__ void __launch_bounds__(NT, 3)
    ssd_chunk_out(const TX* __restrict__ x, const float* __restrict__ dt,
                  const TW* __restrict__ a_log, const float* __restrict__ bm,
                  const float* __restrict__ cm,
                  const TW* __restrict__ d_skip,
                  const float* __restrict__ Sc, TX* __restrict__ y, int S,
                  int Hs, int P, int nc) {
  constexpr int MS = CL + 4;   // row stride of mm (A fragments: 32 banks)
  constexpr int CS = N + 4;    // row stride of cs and st (fragments: 32 banks)
  __shared__ __align__(16) TX xs[2][CL][XP];
  __shared__ __align__(16) float st[2][MAX_P][CS];  // chunk-start state
  __shared__ __align__(16) float bs[CL][N];
  __shared__ __align__(16) float cs[CL][CS];
  __shared__ float bt[N][CL];        // B^T, for C B^T without conflicts
  __shared__ float gm[CL][CL + 1];   // C_t . B_s for s <= t < n, else 0
  __shared__ __align__(16) float mm[CL][MS];   // gm exp(cum_t - cum_s) dt_s
  __shared__ float dts[2][CL], cum[CL], ec[CL], Ah[HG], Dh[HG];
  const int c = blockIdx.x;
  const int b = blockIdx.z;
  const int h0 = blockIdx.y * HG;
  const int h1 = min(Hs, h0 + HG);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t0 = c * CL;
  const int n = min(CL, S - t0);
  const size_t tok0 = (size_t)b * S + t0;
  if (tid < h1 - h0) {
    Ah[tid] = -expf(to_f(a_log[h0 + tid]));
    Dh[tid] = to_f(d_skip[h0 + tid]);
  }
  auto stage_head = [&](int h, int buf) {
    stage_x(xs[buf], x, tok0, n, Hs, h, P);
    const float* sc = Sc + (((size_t)b * Hs + h) * nc + c) * P * N;
    for (int i = tid; i < P * N / 4; i += NT) {
      const int p = i / (N / 4);
      copy16(&st[buf][p][4 * (i - p * (N / 4))], sc + 4 * i, true);
    }
    stage_dt(dts[buf], dt, tok0, n, Hs, h);
  };
  stage_bc<N, N>(bs, bm + tok0 * N, n);
  stage_bc<N, CS>(cs, cm + tok0 * N, n);
  stage_head(h0, 0);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  for (int e = tid; e < CL * N; e += NT) {
    const int s = e / N;
    bt[e - s * N][s] = bs[s][e - s * N];
  }
  __syncthreads();
  // lanes run along s: bt[k][s] is read without bank conflicts and
  // cs[t][k] is one broadcast
  for (int e = tid; e < CL * CL; e += NT) {
    const int t = e / CL;
    const int s = e - t * CL;
    float g = 0.f;
    if (s <= t && t < n) {
#pragma unroll
      for (int k = 0; k < N; ++k) g = fmaf(cs[t][k], bt[k][s], g);
    }
    gm[t][s] = g;
  }

  const int nt8 = P / 8;       // n8 tiles along p
  for (int h = h0; h < h1; ++h) {
    const int buf = (h - h0) & 1;
    if (h + 1 < h1) stage_head(h + 1, buf ^ 1);
    __pipeline_commit();
    __pipeline_wait_prior(1);   // this head's copies landed
    __syncthreads();
    chunk_cum(dts[buf], Ah[h - h0], n, cum);
    __syncthreads();
    for (int t = tid; t < CL; t += NT) ec[t] = expf(cum[t]);
    for (int e = tid; e < CL * CL; e += NT) {
      const int t = e / CL;
      const int s = e - t * CL;
      mm[t][s] = s <= t && t < n
                     ? gm[t][s] * expf(cum[t] - cum[s]) * dts[buf][s]
                     : 0.f;
    }
    __syncthreads();
    const float D = Dh[h - h0];
    for (int tile = warp; tile < (CL / 16) * nt8; tile += NT / 32) {
      const int m0 = 16 * (tile % (CL / 16));
      const int n0 = 8 * (tile / (CL / 16));
      float y1[1][4] = {{0.f, 0.f, 0.f, 0.f}}, c1[1][4] = {{0.f, 0.f, 0.f,
                                                             0.f}};
      float y2[1][4] = {{0.f, 0.f, 0.f, 0.f}}, c2[1][4] = {{0.f, 0.f, 0.f,
                                                             0.f}};
      warp_mma<1, CL>(
          y1, c1, [&](int row, int kk) { return mm[m0 + row][kk]; },
          [&](int kk, int col) { return to_f(xs[buf][kk][n0 + col]); },
          lane);
      warp_mma<1, N>(
          y2, c2, [&](int row, int kk) { return cs[m0 + row][kk]; },
          [&](int kk, int col) { return st[buf][n0 + col][kk]; }, lane);
      const int g = lane >> 2;
      const int p = n0 + 2 * (lane & 3);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = m0 + g + 8 * r;
        if (t < n) {
          const float e_ = ec[t];
          store2(y + ((tok0 + t) * Hs + h) * P + p,
                 fmaf(D, to_f(xs[buf][t][p]),
                      fmaf(e_, y2[0][2 * r] + c2[0][2 * r],
                           y1[0][2 * r] + c1[0][2 * r])),
                 fmaf(D, to_f(xs[buf][t][p + 1]),
                      fmaf(e_, y2[0][2 * r + 1] + c2[0][2 * r + 1],
                           y1[0][2 * r + 1] + c1[0][2 * r + 1])));
        }
      }
    }
    __syncthreads();   // the next head's staging reuses this head's buffers
  }
}

// the pointers and sizes of one call
struct Args {
  const void *x, *dt, *a_log, *b, *c, *d_skip, *state0;
  void *y, *state, *dS, *dA;
  int B, S, Hs, P, has_state;
  cudaStream_t stream;
};

template <typename TX, typename TW, int N>
cudaError_t launch(const Args& a) {
  const TX* x = static_cast<const TX*>(a.x);
  const float* dt = static_cast<const float*>(a.dt);
  const TW* a_log = static_cast<const TW*>(a.a_log);
  const float* bm = static_cast<const float*>(a.b);
  const float* cm = static_cast<const float*>(a.c);
  const TW* d_skip = static_cast<const TW*>(a.d_skip);
  const float* state0 = static_cast<const float*>(a.state0);
  TX* y = static_cast<TX*>(a.y);
  float* state = static_cast<float*>(a.state);
  const int threads = a.P * (N / 4);
  if (a.S < CL) {
    ssm_scan_kernel<TX, TW, N><<<dim3(a.Hs, a.B), threads, 0, a.stream>>>(
        x, dt, a_log, bm, cm, d_skip, state0, y, state, a.S, a.Hs, a.P,
        a.has_state);
    return cudaGetLastError();
  }
  const int nc = (a.S + CL - 1) / CL;
  float* dS = static_cast<float*>(a.dS);
  float* dA = static_cast<float*>(a.dA);
  ssd_chunk_state<TX, TW, N>
      <<<dim3(nc, (a.Hs + HG - 1) / HG, a.B), NT, 0, a.stream>>>(
          x, dt, a_log, bm, dS, dA, a.S, a.Hs, a.P, nc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_state_pass<<<dim3(a.Hs, a.B), threads, 0, a.stream>>>(
      state0, dS, dA, state, a.Hs, a.P * N, nc, a.has_state);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_chunk_out<TX, TW, N>
      <<<dim3(nc, (a.Hs + HG - 1) / HG, a.B), NT, 0, a.stream>>>(
          x, dt, a_log, bm, cm, d_skip, dS, y, a.S, a.Hs, a.P, nc);
  return cudaGetLastError();
}

template <typename TX, typename TW>
cudaError_t launch_n(const Args& a, int N) {
  if (N == 8) return launch<TX, TW, 8>(a);
  if (N == 16) return launch<TX, TW, 16>(a);
  return cudaErrorInvalidValue;
}

template <typename TX>
cudaError_t launch_w(const Args& a, int w_dtype, int N) {
  if (w_dtype == 0) return launch_n<TX, float>(a, N);
  if (w_dtype == 1) return launch_n<TX, __nv_bfloat16>(a, N);
  return cudaErrorInvalidValue;
}

}  // namespace

// The steps per chunk of the chunked path: S >= this takes it.
extern "C" int ssm_scan_chunk() { return CL; }

// x, y (B, S, Hs, P) of type x_dtype (0 float32, 1 bfloat16); dt
// (B, S, Hs), b, c (B, S, N) and state0, state (B, Hs, P, N) float32;
// a_log, d_skip (Hs,) of type w_dtype. All contiguous, and x, b, c and
// the states 16-byte aligned. P a multiple of 16 up to 64, N 8 or 16.
// state0 is read only when has_state is 1 (and may be null otherwise).
// For S >= ssm_scan_chunk() the chunked path runs, with scratch dS
// (B * Hs * nc * P * N floats, 16-byte aligned) and dA (B * Hs * nc
// floats), nc = ceil(S / CL); below it the step kernel runs and dS, dA
// may be null.
extern "C" int ssm_scan_fwd(const void* x, const void* dt, const void* a_log,
                            const void* b, const void* c, const void* d_skip,
                            const void* state0, void* y, void* state,
                            void* dS, void* dA, int x_dtype, int w_dtype,
                            int B, int S, int Hs, int P, int N,
                            int has_state, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || Hs < 1 || P < 16 || P > MAX_P ||
      P % 16 != 0)
    return cudaErrorInvalidValue;
  const Args a{x,  dt, a_log, b, c, d_skip, state0, y,         state,
               dS, dA, B,     S, Hs, P,    has_state, static_cast<cudaStream_t>(stream)};
  if (x_dtype == 0) return launch_w<float>(a, w_dtype, N);
  if (x_dtype == 1) return launch_w<__nv_bfloat16>(a, w_dtype, N);
  return cudaErrorInvalidValue;
}
