// K1: blocked online-softmax attention for prefill (flash attention).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention_bhsd
//   (body _flash_kernel, GQA folding in ops.py::flash_attention).
//
// What bounds it on the H100: operations. Prefill attention does
// 4*B*H*Sq*Sk*dh flops (about half under the causal mask) on inputs of
// (B*Sq*H + 2*B*Sk*KV)*dh elements, so at serving sizes (Sq = Sk = 1024,
// dh = 128) it has well over the ~295 flops per byte at which the bf16
// tensor cores, not the memory, become the limit.
//
// Design. One CTA of 128 threads per (64-row query block, query head,
// batch row); the query head h reads kv head h / G, which folds GQA
// without copying K or V. A loop inside the CTA over 32-key blocks takes
// the place of Pallas' sequential "arbitrary" grid dimension: the running
// max m, the denominator l (shared memory) and the f32 output accumulator
// (registers, 64 x dh spread over the block) stay on chip across key
// blocks, so nothing of size Sq x Sk ever reaches device memory. Key
// blocks that the causal or window mask removes for every row of the
// query block are skipped, which changes no result. Q, K and V tiles are
// read from the model layout (B, S, heads, dh) with strides and held in
// shared memory as f32 with padded rows against bank conflicts; the
// products run on plain FMAs (SIMT). This is the simple, right version:
// it does not reach the tensor-core bound, which needs wgmma/mma tiles
// fed by TMA (a later change). As in the reference, masked scores are
// -1e30, p is rounded to the input type before p @ V, and the output is
// acc / max(l, 1e-30).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;   // query rows per CTA
constexpr int BK = 32;   // keys per inner block
constexpr int NT = 128;  // threads per CTA
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int DH>
constexpr size_t smem_floats() {
  return (size_t)BQ * (DH + 1) + (size_t)BK * (DH + 1) + (size_t)BK * DH +
         (size_t)BQ * (BK + 1) + 3 * BQ;
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
              int H, int KV, int causal, int window, float scale) {
  extern __shared__ float smem[];
  constexpr int QS = DH + 1;       // padded row stride of Q and K tiles
  constexpr int SS = BK + 1;       // padded row stride of the score tile
  float* Qs = smem;                // BQ x QS
  float* Ks = Qs + BQ * QS;        // BK x QS
  float* Vs = Ks + BK * QS;        // BK x DH
  float* Ss = Vs + BK * DH;        // BQ x SS: scores, then p
  float* m_s = Ss + BQ * SS;       // BQ running max
  float* l_s = m_s + BQ;           // BQ running denominator
  float* a_s = l_s + BQ;           // BQ rescale factor of this block

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;

  for (int i = tid; i < BQ * DH; i += NT) {
    const int r = i / DH, d = i % DH, qi = q0 + r;
    Qs[r * QS + d] =
        qi < Sq ? to_f(q[((size_t)(b * Sq + qi) * H + h) * DH + d]) : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  // thread tile: rows ty + 16 i (i < 4), columns tx + 8 j
  const int ty = tid / 8, tx = tid % 8;
  float acc[4][DH / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) acc[i][j] = 0.f;

  // key blocks that hold a valid key for some row of this query block
  const int q_hi = min(q0 + BQ, Sq) - 1;
  int kb_end = (Sk + BK - 1) / BK;
  if (causal) kb_end = min(kb_end, q_hi / BK + 1);
  int kb_begin = 0;
  if (window > 0) kb_begin = max(0, q0 - window + 1) / BK;

  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous block is done with Ks, Vs and Ss
    for (int i = tid; i < BK * DH; i += NT) {
      const int r = i / DH, d = i % DH, ki = k0 + r;
      const bool ok = ki < Sk;
      const size_t off = ((size_t)(b * Sk + ki) * KV + kvh) * DH + d;
      Ks[r * QS + d] = ok ? to_f(k[off]) : 0.f;
      Vs[r * DH + d] = ok ? to_f(v[off]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < DH; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = Ks[(tx + 8 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 8 * j;
        const int qp = q0 + r, kp = k0 + c;
        bool ok = kp < Sk;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        Ss[r * SS + c] = ok ? s[i][j] * scale : NEG_INF;
      }
    __syncthreads();

    {  // online softmax: two threads (one warp) per row, 16 columns each
      const int r = tid / 2, half = tid % 2;
      float* row = Ss + r * SS + half * (BK / 2);
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < BK / 2; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < BK / 2; ++c) {
        const float p = expf(row[c] - m_new);
        sum += p;
        row[c] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      __syncwarp();  // both threads of the row have read m_s[r]
      if (half == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) acc[i][j] *= al;
    }
    for (int c = 0; c < BK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)  // p in the input type, as the reference
        p[i] = to_f(from_f<T>(Ss[(ty + 16 * i) * SS + c]));
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        const float vv = Vs[c * DH + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qi = q0 + r;
    if (qi >= Sq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    T* orow = o + ((size_t)(b * Sq + qi) * H + h) * DH;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) orow[tx + 8 * j] = from_f<T>(acc[i][j] / l);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int H, int KV, int causal,
                   int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<DH>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd<T, DH><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KV, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const void* q, const void* k, const void* v, void* o,
                      int B, int Sq, int Sk, int H, int KV, int dh,
                      int causal, int window, float scale,
                      cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, Sq, Sk, H, KV, causal, window,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, KV, causal, window,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, KV, causal, window,
                            scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, Sq, Sk, H, KV, causal, window,
                            scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Sq, H, dh), k/v (B, Sk, KV, dh), o (B, Sq, H, dh), all contiguous.
// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype, int B,
                                   int Sq, int Sk, int H, int KV, int dh,
                                   int causal, int window, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dh<float>(q, k, v, o, B, Sq, Sk, H, KV, dh, causal, window,
                            scale, s);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KV, dh, causal,
                                    window, scale, s);
  return cudaErrorInvalidValue;
}
