// K4: the mLSTM recurrence (xLSTM matrix memory), with state in and out.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/mlstm_scan/kernel.py::mlstm_scan_bhsd
//   (body _mlstm_kernel, wrapper ops.py::mlstm_scan),
// and computes what the model's step repro/models/xlstm.py::_mlstm_step
// computes, per (batch, head) and time step t:
//   m' = max(log sigmoid(fg_t) + m, ig_t)
//   i  = exp(ig_t - m'),  f = exp(log sigmoid(fg_t) + m - m')
//   C  = f C + i v_t k_t^T   (dh x dh),   n = f n + i k_t
//   h_t = C q_t / max(|n . q_t|, 1)
// Unlike the Pallas kernel it takes an initial state (C0, n0, m0) and
// writes the final one, because the xLSTM serve cache is this state and
// the model's zero state has m = 0, not the kernel's -1e30; without a
// state (has_state = 0) it starts from C = 0, n = 0, m = -1e30 as the
// Pallas kernel does. It runs exactly S steps: the Pallas wrapper's padded
// steps (ig = -1e30, fg = 30) would move m, and the state with it.
//
// What bounds it on the H100: arithmetic on the f32 CUDA cores. Each step
// touches every element of C three times (f C, + i v k, C q): 5 flops per
// element, 5 B H S dh^2 flops in all (21.5 GFLOP at B 4, S 1024, H 4,
// dh 512) against 4 B S H dh f32 of q, k, v, h plus the state in and out
// (168 MB). At 67 TFLOP/s that is 0.32 ms against 0.05 ms of bytes. The
// recurrence is sequential in t, so the parallelism is across the rows of
// C: the TPU kernel keeps one head's whole C in VMEM, but 512 x 512 f32 is
// 1 MiB, above an SM's 227 KB of shared memory.
//
// Design. C is split by rows and held in registers for the whole scan: a
// warp owns RW rows of one (batch, head), a lane owns dh/32 contiguous
// columns of each, and a CTA of NW warps owns NW * RW rows, so the grid is
// (dh / (NW * RW), B * H). The rows of C never meet, so no two warps
// communicate: every warp recomputes the same scalar gates from ig and
// fg, keeps its own copy of n (its lanes' columns) and reduces n . q and
// its rows of C q with warp shuffles. Per step a warp reads q_t and k_t
// (from L2 after the first of the (batch, head)'s warps), its RW values
// of v_t and the two gates, fetching step t + 1 while it computes step t,
// and writes its RW values of h_t. C and n touch device memory once each
// way; the warp of rows 0.. of each (batch, head) writes n and m.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW = 4;           // warps per CTA
constexpr int RW = 4;           // rows of C per warp
constexpr int ROWS = NW * RW;   // rows of C per CTA
constexpr float NEG_INF = -1e30f;

// log sigmoid(x) = -softplus(-x), as jax.nn.log_sigmoid and
// torch.nn.functional.logsigmoid compute it
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

template <int N>
__device__ __forceinline__ void load_vec(float (&dst)[N],
                                         const float* __restrict__ src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int e = 0; e < N; e += 4) {
      const float4 x = *reinterpret_cast<const float4*>(src + e);
      dst[e] = x.x;
      dst[e + 1] = x.y;
      dst[e + 2] = x.z;
      dst[e + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) dst[e] = src[e];
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* __restrict__ dst,
                                          const float (&src)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int e = 0; e < N; e += 4)
      *reinterpret_cast<float4*>(dst + e) =
          make_float4(src[e], src[e + 1], src[e + 2], src[e + 3]);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) dst[e] = src[e];
  }
}

// q, k, v, h (B, S, H, DH); ig, fg (B, S, H); C0, C (B, H, DH, DH);
// n0, n (B, H, DH); m0, m (B, H). All float32.
template <int DH>
__global__ void __launch_bounds__(NW * 32)
    mlstm_scan_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ ig,
                      const float* __restrict__ fg,
                      const float* __restrict__ C0,
                      const float* __restrict__ n0,
                      const float* __restrict__ m0, float* __restrict__ h,
                      float* __restrict__ C_out, float* __restrict__ n_out,
                      float* __restrict__ m_out, int S, int H,
                      int has_state) {
  constexpr int E = DH / 32;  // columns per lane
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int hd = bh - b * H;
  const int row0 = blockIdx.x * ROWS + warp * RW;
  const int col0 = lane * E;

  float c[RW][E], n[E], m;
  if (has_state) {
#pragma unroll
    for (int r = 0; r < RW; ++r)
      load_vec(c[r], C0 + ((size_t)bh * DH + row0 + r) * DH + col0);
    load_vec(n, n0 + (size_t)bh * DH + col0);
    m = m0[bh];
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      n[e] = 0.f;
#pragma unroll
      for (int r = 0; r < RW; ++r) c[r][e] = 0.f;
    }
    m = NEG_INF;
  }

  const size_t tok = (size_t)H * DH;                 // q/k/v/h token stride
  const size_t base = ((size_t)b * S * H + hd) * DH;  // token 0 of (b, hd)
  const float* qp = q + base + col0;
  const float* kp = k + base + col0;
  const float* vp = v + base + row0;
  float* hp = h + base + row0;
  const float* igp = ig + (size_t)b * S * H + hd;
  const float* fgp = fg + (size_t)b * S * H + hd;

  float qc[E], kc[E], vc[RW];
  load_vec(qc, qp);
  load_vec(kc, kp);
  load_vec(vc, vp);
  float igc = igp[0], fgc = fgp[0];

  for (int t = 0; t < S; ++t) {
    // fetch step t + 1 while step t computes
    float qn[E], kn[E], vn[RW], ign = 0.f, fgn = 0.f;
    const bool more = t + 1 < S;
    if (more) {
      const size_t off = (size_t)(t + 1) * tok;
      load_vec(qn, qp + off);
      load_vec(kn, kp + off);
      load_vec(vn, vp + off);
      ign = igp[(size_t)(t + 1) * H];
      fgn = fgp[(size_t)(t + 1) * H];
    }

    const float logf = log_sigmoid(fgc);
    const float m_new = fmaxf(logf + m, igc);
    const float ip = expf(igc - m_new);
    const float fp = expf(logf + m - m_new);
    m = m_new;

    float nq = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      n[e] = fp * n[e] + ip * kc[e];
      nq = fmaf(n[e], qc[e], nq);
    }
    float acc[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const float iv = ip * vc[r];
      float a = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        c[r][e] = fmaf(iv, kc[e], fp * c[r][e]);
        a = fmaf(c[r][e], qc[e], a);
      }
      acc[r] = a;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      nq += __shfl_xor_sync(0xffffffffu, nq, off);
#pragma unroll
      for (int r = 0; r < RW; ++r)
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
    }
    const float den = fmaxf(fabsf(nq), 1.f);
    float out = acc[0];
#pragma unroll
    for (int r = 1; r < RW; ++r)
      if (lane == r) out = acc[r];
    if (lane < RW) hp[(size_t)t * tok + lane] = out / den;

    if (more) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        qc[e] = qn[e];
        kc[e] = kn[e];
      }
#pragma unroll
      for (int r = 0; r < RW; ++r) vc[r] = vn[r];
      igc = ign;
      fgc = fgn;
    }
  }

#pragma unroll
  for (int r = 0; r < RW; ++r)
    store_vec(C_out + ((size_t)bh * DH + row0 + r) * DH + col0, c[r]);
  if (row0 == 0) {
    store_vec(n_out + (size_t)bh * DH + col0, n);
    if (lane == 0) m_out[bh] = m;
  }
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* ig, const float* fg, const float* C0,
                   const float* n0, const float* m0, float* h, float* C,
                   float* n, float* m, int B, int S, int H, int has_state,
                   cudaStream_t stream) {
  mlstm_scan_kernel<DH><<<dim3(DH / ROWS, B * H), NW * 32, 0, stream>>>(
      q, k, v, ig, fg, C0, n0, m0, h, C, n, m, S, H, has_state);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, h (B, S, H, dh); ig, fg (B, S, H); C0, C (B, H, dh, dh);
// n0, n (B, H, dh); m0, m (B, H); all float32 and contiguous. C0, n0, m0
// are read only when has_state is 1 (and may be null otherwise).
extern "C" int mlstm_scan_fwd(const void* q, const void* k, const void* v,
                              const void* ig, const void* fg, const void* C0,
                              const void* n0, const void* m0, void* h,
                              void* C, void* n, void* m, int B, int S, int H,
                              int dh, int has_state, void* stream) {
  if (B < 1 || S < 1 || H < 1 || B * H > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MLSTM_CASE(D)                                                        \
  case D:                                                                    \
    return launch<D>(static_cast<const float*>(q),                           \
                     static_cast<const float*>(k),                           \
                     static_cast<const float*>(v),                           \
                     static_cast<const float*>(ig),                          \
                     static_cast<const float*>(fg),                          \
                     static_cast<const float*>(C0),                          \
                     static_cast<const float*>(n0),                          \
                     static_cast<const float*>(m0), static_cast<float*>(h),  \
                     static_cast<float*>(C), static_cast<float*>(n),         \
                     static_cast<float*>(m), B, S, H, has_state, st);
  switch (dh) {
    MLSTM_CASE(32)
    MLSTM_CASE(64)
    MLSTM_CASE(128)
    MLSTM_CASE(256)
    MLSTM_CASE(512)
    default:
      return cudaErrorInvalidValue;
  }
#undef MLSTM_CASE
}
