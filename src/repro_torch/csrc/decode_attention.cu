// K2 and K3: single-token decode attention against a KV cache
// (flash-decoding), over a bf16/f32 cache (K2) or an int8 cache with one
// f32 scale per (slot, kv head) (K3).
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/decode_attention/kernel.py::decode_attention_bhd
//   (K2, body _decode_kernel, wrapper ops.py::decode_attention) and
//   src/repro/kernels/decode_attention/kernel.py::decode_attention_bhd_q8
//   (K3, body _decode_kernel_q8, wrapper ops.py::decode_attention_quant).
//
// What bounds it on the H100: bytes. One query token per head streams the
// whole cache: 2*B*S*KV*dh cache elements (plus, for K3, 2*B*S*KV scales)
// against 4*B*H*S*dh flops, i.e. about G/2 flops per cache byte in bf16 and
// G flops per byte in int8 (G = H/KV query heads per kv head) -- far below
// the ~295 flops per byte where the tensor cores would bind. Per launch
// the host does no more than the launch itself: the kernel works out
// each slot's position from (pos, S, ring), and the shared-memory limit
// is raised once per kernel and device, not at every call.
//
// Design. The TPU kernel walks the cache of one (batch, kv head) row in
// one sequential pass; here B*KV is only 16-32 rows at serving sizes
// against 132 SMs, so the cache is split across CTAs (split-K): a CTA of
// four warps per (slot chunk, batch*kv-head row). Each warp runs its own
// online softmax over every fourth slot of the chunk for all G query heads
// of the kv head at once, so each cache row is read from device memory
// once for the G heads that share it; a lane holds dh/32 contiguous
// elements, so a warp reads one cache row in coalesced segments. The
// kernel computes each slot's position itself (in place of Pallas'
// scalar-prefetched slot_pos) and skips slots that are invalid for this
// query (never written, in the future, or outside the window) without
// reading their K/V bytes. The four warps' (m, l, acc) merge in shared memory into one
// partial per chunk; a second small kernel merges the chunks' partials
// and normalises. K3 dequantizes int8 with its scale in registers,
// upcasts q to f32 and keeps p in f32 for p @ V, as the Pallas kernel
// does; K2 rounds p to the cache type before p @ V, as its reference.
// Masking and the final acc / max(l, 1e-30) follow the reference.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int NW = 4;         // warps per CTA
constexpr int NT = NW * 32;   // threads per CTA
constexpr float NEG_INF = -1e30f;
constexpr int MAX_DEVICES = 64;

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The position that slot s holds when the query sits at pos, -1 if the
// slot was never written: a full cache holds position s once s <= pos; a
// ring of S slots holds the latest p <= pos with p % S == s (the
// reference's full and ring slot positions).
__device__ __forceinline__ int slot_position(int s, int S, int pos,
                                             bool ring) {
  if (!ring) return s <= pos ? s : -1;
  int r = (pos - s) % S;
  if (r < 0) r += S;
  return pos - r >= 0 ? pos - r : -1;
}

// Let Kernel take dynamic shared memory up to the device's opt-in limit.
// Set once per (kernel, device): a template's static locals are its own.
template <auto Kernel>
cudaError_t allow_optin_smem() {
  static std::once_flag once[MAX_DEVICES];
  static cudaError_t result[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [dev] {
    int optin = 0;
    result[dev] = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (result[dev] == cudaSuccess)
      result[dev] = cudaFuncSetAttribute(
          Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  });
  return result[dev];
}

size_t split_smem_bytes(int G, int dh) {
  return sizeof(float) *
         ((size_t)G * dh + (size_t)NW * G * dh + 2 * (size_t)NW * G);
}

// One CTA per (chunk of slots, batch*kv-head row). T is the type of q and
// of the output; C is the cache element type (T for K2, int8 for K3).
template <typename T, typename C, int DH, bool Q8>
__global__ void __launch_bounds__(NT)
    decode_split(const T* __restrict__ q, const C* __restrict__ k,
                 const float* __restrict__ k_scale, const C* __restrict__ v,
                 const float* __restrict__ v_scale,
                 float* __restrict__ o_part, float* __restrict__ ml_part,
                 int S, int H, int KV, int pos, int window, int ring,
                 int chunk, float scale) {
  constexpr int E = DH / 32;  // elements per lane
  extern __shared__ float sm[];
  const int G = H / KV;
  float* qs = sm;                   // G x DH
  float* acc = qs + G * DH;         // NW x G x DH
  float* ms = acc + NW * G * DH;    // NW x G
  float* ls = ms + NW * G;          // NW x G

  const int split = blockIdx.x, n_splits = gridDim.x;
  const int bkv = blockIdx.y, b = bkv / KV, kvh = bkv % KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < G * DH; i += NT)
    qs[i] = to_f(q[((size_t)b * H + (size_t)kvh * G) * DH + i]);
  for (int i = threadIdx.x; i < NW * G * DH; i += NT) acc[i] = 0.f;
  for (int i = threadIdx.x; i < NW * G; i += NT) {
    ms[i] = NEG_INF;
    ls[i] = 0.f;
  }
  __syncthreads();

  float* accw = acc + warp * G * DH;
  float* mw = ms + warp * G;
  float* lw = ls + warp * G;
  const int s0 = split * chunk, s1 = min(S, s0 + chunk);
  for (int s = s0 + warp; s < s1; s += NW) {
    const int sp = slot_position(s, S, pos, ring != 0);
    if (sp < 0 || sp > pos || (window > 0 && sp <= pos - window)) continue;
    const size_t slot = (size_t)(b * S + s) * KV + kvh;
    const size_t row = slot * DH + lane * E;
    float kf[E], vf[E];
    if constexpr (Q8) {
      const float ksc = k_scale[slot], vsc = v_scale[slot];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        kf[e] = (float)k[row + e] * ksc;
        vf[e] = (float)v[row + e] * vsc;
      }
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        kf[e] = to_f(k[row + e]);
        vf[e] = to_f(v[row + e]);
      }
    }
    for (int g = 0; g < G; ++g) {
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) d = fmaf(qs[g * DH + lane * E + e], kf[e], d);
      d = warp_sum(d) * scale;
      const float m_old = mw[g], l_old = lw[g];
      const float m_new = fmaxf(m_old, d);
      const float alpha = expf(m_old - m_new);
      const float p = expf(d - m_new);
      float pv = p;  // K3 keeps p in f32
      if constexpr (!Q8) pv = to_f(from_f<C>(p));
      float* a = accw + g * DH + lane * E;
#pragma unroll
      for (int e = 0; e < E; ++e) a[e] = fmaf(pv, vf[e], alpha * a[e]);
      __syncwarp();  // every lane has read mw[g], lw[g]
      if (lane == 0) {
        mw[g] = m_new;
        lw[g] = alpha * l_old + p;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  const size_t part = (size_t)bkv * n_splits + split;
  for (int i = threadIdx.x; i < G * DH; i += NT) {
    const int g = i / DH;
    float M = NEG_INF;
    for (int w = 0; w < NW; ++w) M = fmaxf(M, ms[w * G + g]);
    float o = 0.f;
    for (int w = 0; w < NW; ++w)
      o += acc[w * G * DH + i] * expf(ms[w * G + g] - M);
    o_part[part * G * DH + i] = o;
  }
  for (int g = threadIdx.x; g < G; g += NT) {
    float M = NEG_INF;
    for (int w = 0; w < NW; ++w) M = fmaxf(M, ms[w * G + g]);
    float L = 0.f;
    for (int w = 0; w < NW; ++w) L += ls[w * G + g] * expf(ms[w * G + g] - M);
    ml_part[(part * G + g) * 2] = M;
    ml_part[(part * G + g) * 2 + 1] = L;
  }
}

// One CTA of dh threads per (batch*kv-head row, query head in the group).
template <typename T>
__global__ void decode_combine(const float* __restrict__ o_part,
                               const float* __restrict__ ml_part,
                               T* __restrict__ o, int n_splits, int H,
                               int KV, int DH) {
  const int G = H / KV;
  const int bkv = blockIdx.x / G, g = blockIdx.x % G;
  const int b = bkv / KV, kvh = bkv % KV;
  const int d = threadIdx.x;
  float M = NEG_INF;
  for (int sp = 0; sp < n_splits; ++sp)
    M = fmaxf(M, ml_part[(((size_t)bkv * n_splits + sp) * G + g) * 2]);
  float L = 0.f, acc = 0.f;
  for (int sp = 0; sp < n_splits; ++sp) {
    const size_t part = (size_t)bkv * n_splits + sp;
    const float w = expf(ml_part[(part * G + g) * 2] - M);
    L += ml_part[(part * G + g) * 2 + 1] * w;
    acc += o_part[(part * G + g) * DH + d] * w;
  }
  o[((size_t)b * H + (size_t)kvh * G + g) * DH + d] =
      from_f<T>(acc / fmaxf(L, 1e-30f));
}

template <typename T, typename C, bool Q8, int DH>
cudaError_t launch(const void* q, const void* k, const void* ks,
                   const void* v, const void* vs, void* o, float* o_part,
                   float* ml_part, int B, int S, int H, int KV, int pos,
                   int window, int ring, int n_splits, int chunk,
                   float scale, cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem = split_smem_bytes(G, DH);
  cudaError_t err = allow_optin_smem<decode_split<T, C, DH, Q8>>();
  if (err != cudaSuccess) return err;
  decode_split<T, C, DH, Q8><<<dim3(n_splits, B * KV), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const C*>(k),
      static_cast<const float*>(ks), static_cast<const C*>(v),
      static_cast<const float*>(vs), o_part, ml_part, S, H, KV, pos, window,
      ring, chunk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine<T><<<B * KV * G, DH, 0, stream>>>(
      o_part, ml_part, static_cast<T*>(o), n_splits, H, KV, DH);
  return cudaGetLastError();
}

template <typename T, typename C, bool Q8>
cudaError_t launch_dh(int dh, const void* q, const void* k, const void* ks,
                      const void* v, const void* vs, void* o, float* o_part,
                      float* ml_part, int B, int S, int H, int KV, int pos,
                      int window, int ring, int n_splits, int chunk,
                      float scale, cudaStream_t stream) {
#define DECODE_CASE(D)                                                       \
  case D:                                                                    \
    return launch<T, C, Q8, D>(q, k, ks, v, vs, o, o_part, ml_part, B, S, H, \
                               KV, pos, window, ring, n_splits, chunk,       \
                               scale, stream);
  switch (dh) {
    DECODE_CASE(32)
    DECODE_CASE(64)
    DECODE_CASE(128)
    DECODE_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef DECODE_CASE
}

}  // namespace

// K2. q (B, 1, H, dh); k/v (B, S, KV, dh) of q's type; o (B, 1, H, dh);
// o_part (B*KV, n_splits, G, dh) f32 and ml_part (B*KV, n_splits, G, 2) f32
// scratch. dtype: 0 = f32, 1 = bf16. ring: 0 = full cache, 1 = ring.
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, void* o, void* o_part,
                                    void* ml_part, int dtype, int B, int S,
                                    int H, int KV, int dh, int pos,
                                    int window, int ring, int n_splits,
                                    int chunk, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* op = static_cast<float*>(o_part);
  float* mlp = static_cast<float*>(ml_part);
  if (dtype == 0)
    return launch_dh<float, float, false>(dh, q, k, nullptr, v, nullptr, o,
                                          op, mlp, B, S, H, KV, pos, window,
                                          ring, n_splits, chunk, scale, st);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16, __nv_bfloat16, false>(
        dh, q, k, nullptr, v, nullptr, o, op, mlp, B, S, H, KV, pos, window,
        ring, n_splits, chunk, scale, st);
  return cudaErrorInvalidValue;
}

// K3. As K2, with k/v (B, S, KV, dh) int8 and k_scale/v_scale (B, S, KV) f32.
extern "C" int decode_attention_q8_fwd(const void* q, const void* k,
                                       const void* k_scale, const void* v,
                                       const void* v_scale, void* o,
                                       void* o_part, void* ml_part, int dtype,
                                       int B, int S, int H, int KV, int dh,
                                       int pos, int window, int ring,
                                       int n_splits, int chunk, float scale,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* op = static_cast<float*>(o_part);
  float* mlp = static_cast<float*>(ml_part);
  if (dtype == 0)
    return launch_dh<float, int8_t, true>(dh, q, k, k_scale, v, v_scale, o,
                                          op, mlp, B, S, H, KV, pos, window,
                                          ring, n_splits, chunk, scale, st);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16, int8_t, true>(
        dh, q, k, k_scale, v, v_scale, o, op, mlp, B, S, H, KV, pos, window,
        ring, n_splits, chunk, scale, st);
  return cudaErrorInvalidValue;
}
