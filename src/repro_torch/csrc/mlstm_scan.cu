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
// Two paths, chosen by S. From CL steps up (prefill) the chunkwise-
// parallel form below runs; under CL steps (decode is S = 1) the step
// kernel runs the recurrence as written.
//
// What bounds it on the H100. The step form touches every element of C
// three times a step (f C, + i v k, C q: 5 dh^2 flops), 21.5 GFLOP at
// B 4, S 1024, H 4, dh 512, 0.32 ms on the f32 CUDA cores. The chunkwise
// form needs two dh x dh products a step (4 dh^2 flops, plus 4 CL dh for
// the chunk's own attention), which run on the tensor cores at f32
// accuracy in 3xTF32 (a third of the 495 TFLOP/s TF32 peak): 0.104 ms,
// against 0.05 ms for the bytes (q, k, v, h and the state in and out).
//
// The step kernel. C is split by rows and held in registers for the whole
// scan: a warp owns RW rows of one (batch, head), a lane owns dh/32
// contiguous columns of each, and a CTA of NW warps owns NW * RW rows, so
// the grid is (dh / (NW * RW), B * H). The rows of C never meet, so no two
// warps communicate: every warp recomputes the same scalar gates from ig
// and fg, keeps its own copy of n (its lanes' columns) and reduces n . q
// and its rows of C q with warp shuffles. Per step a warp reads q_t and
// k_t, its RW values of v_t and the two gates, fetching step t + 1 while
// it computes step t, and writes its RW values of h_t. C and n touch
// device memory once each way; the warp of rows 0.. of each (batch, head)
// writes n and m.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "sm90_helpers.cuh"

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

// --- the chunkwise path ----------------------------------------------------
//
// For S >= CL steps the scan runs in chunks of CL steps. Per (batch, head)
// and chunk, with m0, C0, n0 the state at the chunk's start and F_t the sum
// of log sigmoid(fg) over the chunk's steps up to t (m_t from the step
// recurrence, so m stays exact):
//   a_t  = exp(m0 + F_t - m_t)
//   D_ts = exp(ig_s + F_t - F_s - m_t) for s <= t, else 0 (masked first)
//   P    = D o (Q K^T)                                   (CL x CL)
//   h_t  = (P V + a_t Q C0^T)_t / max(|a_t n0 . q_t + sum_s P_ts|, 1)
// and at the chunk's end, with g = exp(m0 + F_L - m_L) and
// w_s = exp(ig_s + F_L - F_s - m_L):
//   C = g C0 + (w o V)^T K,   n = g n0 + sum_s w_s k_s.
// Every exponent is at most 0: m_t bounds each term.
//
// Two launches. mlstm_chunk_prep, one CTA per (chunk, batch * head), runs
// the scalar m recurrence up to its chunk, forms F, D, P = D o Q K^T and
// the gate vectors (a, sum_s P_ts, w, g) once per chunk, and writes P^T
// and the vectors to scratch. mlstm_chunk_state, one CTA per (R rows of
// C, batch * head), keeps its R x dh block of C (transposed, [j][r]) and
// all of n in shared memory and walks the chunks in order: P V, then over
// slices of JW columns of q and k (staged by cp.async, the next slice in
// flight while this one computes) Q C0^T and n0 . q on the slice's old
// C, n, and then the slice's update of C and n. A row block of C only
// meets its own rows of v and h, so the CTAs of one (batch, head) never
// communicate. The products are warp tiles of mma.sync m16n8k8 in
// 3xTF32 (TF32X3 below), the hi.hi and the two small products summed in
// separate accumulators so that each mma chain is a third as long.

constexpr int CL = 64;     // steps per chunk
constexpr int JW = 32;     // columns of q, k (and of C) per staged slice
constexpr int NT = 256;    // threads per CTA of both chunk kernels

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with ok false the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The matrix products of both chunk kernels (Q K^T; P V, Q C0^T and
// (w o V)^T K) run on the tensor cores in 3xTF32 (mma.sync m16n8k8: each
// f32 operand split into a TF32 high and a TF32 low part, lo.hi + hi.lo +
// hi.hi summed in f32, which keeps close to f32's accuracy; plain TF32
// would break the scan's 1e-4), or with false here as register-tiled f32
// FMAs on the CUDA cores.
constexpr bool TF32X3 = true;

using repro_sm90::warp_mma;

// q, k (B, S, H, DH); ig, fg (B, S, H); m0 (B, H); PT (B*H, nc, CL, CL)
// as P^T ([s][t]); gates (B*H, nc, 4, CL): a, sum_s P_ts, w, g (at 0);
// m_out (B, H), written by the last chunk's CTA.
template <int DH>
__global__ void __launch_bounds__(NT)
    mlstm_chunk_prep(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ ig,
                     const float* __restrict__ fg,
                     const float* __restrict__ m0, float* __restrict__ PT,
                     float* __restrict__ gates, float* __restrict__ m_out,
                     int S, int H, int nc, int has_state) {
  constexpr int TT = CL / 16;   // rows t and columns s of P per thread
  constexpr int TS = CL + 8;    // row stride of the slices (see ChunkSmem)
  __shared__ __align__(16) float qt[JW][TS];   // a slice of q, [j][t]
  __shared__ __align__(16) float kt[JW][TS];   // a slice of k, [j][s]
  __shared__ float rsp[8][CL];  // row sums of P, a row per warp column
  __shared__ float lf[NT], igs[NT];
  __shared__ float Fc[CL], mc[CL], igc[CL];
  __shared__ float m_start;

  const int c = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int hd = bh - b * H;
  const int tid = threadIdx.x;
  const int t0 = c * CL;
  const int n = min(CL, S - t0);
  const int t_end = t0 + n;
  const float* igp = ig + (size_t)b * S * H + hd;   // step t at [t * H]
  const float* fgp = fg + (size_t)b * S * H + hd;

  // m by the step recurrence up to the chunk's end (thread 0), the log
  // sigmoids NT steps at a time by all threads
  float m = has_state ? m0[bh] : NEG_INF;
  float F = 0.f;
  float fgv = 0.f, igv = 0.f;   // this thread's step of the next pass
  if (tid < t_end) {
    fgv = fgp[(size_t)tid * H];
    igv = igp[(size_t)tid * H];
  }
  for (int base = 0; base < t_end; base += NT) {
    const int cnt = min(NT, t_end - base);
    if (tid < cnt) {
      lf[tid] = log_sigmoid(fgv);
      igs[tid] = igv;
    }
    __syncthreads();
    if (base + NT + tid < t_end) {
      fgv = fgp[(size_t)(base + NT + tid) * H];
      igv = igp[(size_t)(base + NT + tid) * H];
    }
    if (tid == 0) {
      const int pre = min(cnt, max(0, t0 - base));   // steps before t0
#pragma unroll 8
      for (int i = 0; i < pre; ++i) m = fmaxf(lf[i] + m, igs[i]);
      for (int i = pre; i < cnt; ++i) {
        const int t = base + i;
        if (t == t0) m_start = m;
        const float m_new = fmaxf(lf[i] + m, igs[i]);
        F += lf[i];
        Fc[t - t0] = F;
        mc[t - t0] = m_new;
        igc[t - t0] = igs[i];
        m = m_new;
      }
    }
    __syncthreads();
  }
  if (tid == 0 && c == nc - 1) m_out[bh] = m;

  // Q K^T over slices of JW columns. On the tensor cores warp
  // (w % WM, w / WM) holds rows 16 (w % WM).. and NTP column tiles of 8
  // from (w / WM) * CL / WN; on the CUDA cores thread (tg, sg) holds rows
  // tg * TT.. and columns sg * TT..
  constexpr int WM = CL / 16;
  constexpr int WN = 8 / WM;
  constexpr int NTP = CL / WN / 8;
  constexpr int AP = TF32X3 ? NTP * 4 : TT * TT;   // outputs a thread
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int mt = 16 * (warp % WM);
  const int ns = (warp / WM) * (CL / WN);
  const int sg = tid % 16;
  const int tg = tid / 16;
  const size_t tok = (size_t)H * DH;
  const float* qb = q + ((size_t)b * S + t0) * tok + (size_t)hd * DH;
  const float* kb = k + ((size_t)b * S + t0) * tok + (size_t)hd * DH;
  float acc[AP], cor[AP];
#pragma unroll
  for (int i = 0; i < AP; ++i) acc[i] = cor[i] = 0.f;
  // each thread fetches QL float4s of q and of k per slice, the next
  // slice's into registers while this one computes
  constexpr int QL = CL * (JW / 4) / NT;
  float4 qn[QL], kn[QL];
  auto fetch = [&](int j0) {
#pragma unroll
    for (int u = 0; u < QL; ++u) {
      const int e = tid + u * NT;
      const int t = e % CL;
      const int jq = e / CL;
      qn[u] = kn[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < n) {
        qn[u] = *reinterpret_cast<const float4*>(qb + t * tok + j0 + 4 * jq);
        kn[u] = *reinterpret_cast<const float4*>(kb + t * tok + j0 + 4 * jq);
      }
    }
  };
  fetch(0);
  for (int j0 = 0; j0 < DH; j0 += JW) {
#pragma unroll
    for (int u = 0; u < QL; ++u) {
      const int e = tid + u * NT;
      const int t = e % CL;
      const int jq = e / CL;
      qt[4 * jq][t] = qn[u].x;
      qt[4 * jq + 1][t] = qn[u].y;
      qt[4 * jq + 2][t] = qn[u].z;
      qt[4 * jq + 3][t] = qn[u].w;
      kt[4 * jq][t] = kn[u].x;
      kt[4 * jq + 1][t] = kn[u].y;
      kt[4 * jq + 2][t] = kn[u].z;
      kt[4 * jq + 3][t] = kn[u].w;
    }
    __syncthreads();
    if (j0 + JW < DH) fetch(j0 + JW);
    if constexpr (TF32X3) {
      warp_mma<NTP, JW>(reinterpret_cast<float(&)[NTP][4]>(acc),
                        reinterpret_cast<float(&)[NTP][4]>(cor),
                        [&](int row, int kk) { return qt[kk][mt + row]; },
                        [&](int kk, int col) { return kt[kk][ns + col]; },
                        lane);
    } else {
#pragma unroll 4
      for (int j = 0; j < JW; ++j) {
        float qa[TT], ka[TT];
        load_vec(qa, &qt[j][tg * TT]);
        load_vec(ka, &kt[j][sg * TT]);
#pragma unroll
        for (int i = 0; i < TT; ++i)
#pragma unroll
          for (int l = 0; l < TT; ++l)
            acc[i * TT + l] = fmaf(qa[i], ka[l], acc[i * TT + l]);
      }
    }
    __syncthreads();
  }

  // P = D o Q K^T (masked before the exp), its row sums, P^T to scratch
  float* pc = PT + ((size_t)bh * nc + c) * CL * CL;
  float* gc = gates + ((size_t)bh * nc + c) * 4 * CL;
  const int fr = lane >> 2;      // fragment row group
  const int fq = lane & 3;       // fragment column pair
  auto p_t = [&](int i) {
    return TF32X3 ? mt + fr + 8 * ((i & 3) >> 1) : tg * TT + i / TT;
  };
  auto p_s = [&](int i) {
    return TF32X3 ? ns + 8 * (i >> 2) + 2 * fq + (i & 1) : sg * TT + i % TT;
  };
  float rs[2] = {0.f, 0.f};      // row sums: rows p_t(0), p_t(2) (TF32X3)
#pragma unroll
  for (int i = 0; i < AP; ++i) {
    const int t = p_t(i);
    const int s = p_s(i);
    float p = 0.f;
    if (t < n && s <= t)
      p = expf(igc[s] + Fc[t] - Fc[s] - mc[t]) * (acc[i] + cor[i]);
    pc[s * CL + t] = p;
    if constexpr (TF32X3) {
      rs[(i & 3) >> 1] += p;
    } else {
      acc[i] = p;
    }
  }
  if constexpr (TF32X3) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
    }
    if (fq == 0) {
      rsp[warp / WM][mt + fr] = rs[0];
      rsp[warp / WM][mt + fr + 8] = rs[1];
    }
    __syncthreads();
    if (tid < CL) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < WN; ++w) sum += rsp[w][tid];
      gc[CL + tid] = sum;
    }
  } else {
#pragma unroll
    for (int i = 0; i < TT; ++i) {
      float r = 0.f;
#pragma unroll
      for (int l = 0; l < TT; ++l) r += acc[i * TT + l];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        r += __shfl_xor_sync(0xffffffffu, r, off);
      if (sg == 0) gc[CL + tg * TT + i] = r;
    }
  }
  if (tid < CL) {
    const int t = tid;
    const float FL = Fc[n - 1], mL = mc[n - 1];
    gc[t] = t < n ? expf(m_start + Fc[t] - mc[t]) : 0.f;
    gc[2 * CL + t] = t < n ? expf(igc[t] + FL - Fc[t] - mL) : 0.f;
    if (t == 0) gc[3 * CL] = expf(m_start + FL - mL);
  }
}

// shared memory of mlstm_chunk_state, in floats. Row strides are padded
// so that the tensor-core fragments' reads (8 rows x 4 columns, or 4 rows
// x 8 columns, a warp) fall in 32 distinct banks.
template <int DH, int R>
struct ChunkSmem {
  static constexpr int CS = R + 8;           // C^T [j][r]
  static constexpr int QS = JW + 4;          // q slice [t][j]
  static constexpr int KS = JW + 8;          // k slice [s][j]
  static constexpr int VS = R + 8;           // v, then w o v [s][r]
  static constexpr int PS = CL + 8;          // P^T [s][t]
  static constexpr int CT = DH * CS;
  static constexpr int QK = CL * (QS + KS);  // one buffer of q and k slices
  static constexpr int V = CL * VS;
  static constexpr int P = CL * PS;
  static constexpr int G = 4 * CL;           // a, sum_s P_ts, w, g
  static constexpr int total = CT + 2 * QK + V + P + G + DH + CL;
  static constexpr size_t bytes = sizeof(float) * total;
};

// q, k, v, h (B, S, H, DH); C0, C_out (B, H, DH, DH); n0, n_out (B, H, DH);
// PT, gates as mlstm_chunk_prep writes them.
template <int DH, int R>
__global__ void __launch_bounds__(NT, 1)
    mlstm_chunk_state(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ C0,
                      const float* __restrict__ n0,
                      const float* __restrict__ PT,
                      const float* __restrict__ gates, float* __restrict__ h,
                      float* __restrict__ C_out, float* __restrict__ n_out,
                      int S, int H, int nc, int has_state) {
  using SM = ChunkSmem<DH, R>;
  constexpr int CS = SM::CS, QS = SM::QS, KS = SM::KS, VS = SM::VS,
                PS = SM::PS;
  constexpr int NQP = NT / CL;  // threads per t of n0 . q_t
  static_assert(R % 16 == 0 && DH % R == 0 && DH % JW == 0 &&
                    R * DH % (4 * NT) == 0 && CL % 16 == 0,
                "tiling");
  extern __shared__ __align__(16) float smem[];
  float* ct = smem;                  // C^T block [DH][CS]
  float* qk = ct + SM::CT;           // 2 buffers x (q [CL][QS], k [CL][KS])
  float* vs = qk + 2 * SM::QK;       // v [CL][VS]
  float* pts = vs + SM::V;           // P^T [CL][PS]
  float* gs = pts + SM::P;           // gate vectors [4][CL]
  float* nv = gs + SM::G;            // n [DH]
  float* nq = nv + DH;               // n0 . q_t [CL]

  const int row0 = blockIdx.x * R;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int hd = bh - b * H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (has_state) {
    const float* cp = C0 + ((size_t)bh * DH + row0) * DH;
#pragma unroll 8
    for (int u = 0; u < R * (DH / 4) / NT; ++u) {
      const int e = tid + u * NT;
      const int r = e % R;
      const int jq = e / R;
      const float4 x =
          *reinterpret_cast<const float4*>(cp + (size_t)r * DH + 4 * jq);
      ct[(4 * jq) * CS + r] = x.x;
      ct[(4 * jq + 1) * CS + r] = x.y;
      ct[(4 * jq + 2) * CS + r] = x.z;
      ct[(4 * jq + 3) * CS + r] = x.w;
    }
    for (int j = tid; j < DH; j += NT) nv[j] = n0[(size_t)bh * DH + j];
  } else {
    for (int e = tid; e < SM::CT; e += NT) ct[e] = 0.f;
    for (int j = tid; j < DH; j += NT) nv[j] = 0.f;
  }

  const size_t tok = (size_t)H * DH;
  const size_t base = (size_t)b * S * tok + (size_t)hd * DH;
  const float* qb = q + base;        // token t at [t * tok]
  const float* kb = k + base;
  const float* vb = v + base + row0;
  float* hb = h + base + row0;

  auto stage_slice = [&](int t0, int n, int j0, int buf) {
    float* qs = qk + buf * SM::QK;
    float* ks = qs + CL * QS;
    for (int e = tid; e < CL * (JW / 4); e += NT) {
      const int t = e / (JW / 4);
      const int jq = e % (JW / 4);
      const bool ok = t < n;
      const size_t off = (size_t)(t0 + (ok ? t : 0)) * tok + j0 + 4 * jq;
      cp_async16(qs + t * QS + 4 * jq, qb + off, ok);
      cp_async16(ks + t * KS + 4 * jq, kb + off, ok);
    }
  };

  // the (t, r) outputs: on the tensor cores warp (w % WM, w / WM) holds
  // rows 16 (w % WM).. and NT1 column tiles of 8 from n1 = (w / WM) * R /
  // WN; on the CUDA cores thread (rg, cg) holds TT rows rg * TT.. and RT
  // columns cg * RT..
  constexpr int WM = CL / 16;        // warps along t (and along r: WM2)
  constexpr int WN = 8 / WM;
  constexpr int NT1 = R / WN / 8;
  constexpr int WM2 = R / 16;        // the update's warps along r
  constexpr int WN2 = 8 / WM2;
  constexpr int NT2 = JW / WN2 / 8;
  static_assert(8 % WM == 0 && NT1 >= 1 && 8 % WM2 == 0 && NT2 >= 1,
                "warp tiling");
  constexpr int TT = CL / 16;
  constexpr int RT = R / 16;
  constexpr int JT = JW / 16;
  constexpr int A1 = TF32X3 ? NT1 * 4 : TT * RT;   // accumulators a thread
  const int m1 = 16 * (warp % WM);
  const int n1 = (warp / WM) * (R / WN);
  const int m2 = 16 * (warp % WM2);
  const int n2 = (warp / WM2) * (JW / WN2);
  const int cg = tid % 16;
  const int rg = tid / 16;
  const int fg = lane >> 2;          // fragment row group
  const int fq = lane & 3;           // fragment column pair
  // a thread's i-th output (t, r) of the (t, r) products
  auto out_t = [&](int i) {
    return TF32X3 ? m1 + fg + 8 * ((i & 3) >> 1) : rg * TT + i / RT;
  };
  auto out_r = [&](int i) {
    return TF32X3 ? n1 + 8 * (i >> 2) + 2 * fq + (i & 1) : cg * RT + i % RT;
  };

  const int n_slices = DH / JW;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * CL;
    const int n = min(CL, S - t0);
    // v rows, P^T and the gate vectors of the chunk, and its first slice
    for (int e = tid; e < CL * (R / 4); e += NT) {
      const int s = e / (R / 4);
      const int rq = e % (R / 4);
      const bool ok = s < n;
      cp_async16(vs + s * VS + 4 * rq,
                 vb + (size_t)(t0 + (ok ? s : 0)) * tok + 4 * rq, ok);
    }
    const float* pc = PT + ((size_t)bh * nc + c) * CL * CL;
    for (int e = tid; e < CL * CL / 4; e += NT) {
      const int s = e / (CL / 4);
      const int tq = e % (CL / 4);
      cp_async16(pts + s * PS + 4 * tq, pc + 4 * e, true);
    }
    const float* gc = gates + ((size_t)bh * nc + c) * 4 * CL;
    for (int e = tid; e < CL; e += NT) cp_async16(gs + 4 * e, gc + 4 * e, true);
    stage_slice(t0, n, 0, 0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    // P V on the raw v; then v becomes w o v for the update
    // (on the tensor cores qc2, pv2 hold the small products' sums)
    float pv[A1], qc[A1], pv2[A1], qc2[A1];
#pragma unroll
    for (int i = 0; i < A1; ++i) pv[i] = qc[i] = pv2[i] = qc2[i] = 0.f;
    if constexpr (TF32X3) {
      warp_mma<NT1, CL>(
          reinterpret_cast<float(&)[NT1][4]>(pv),
          reinterpret_cast<float(&)[NT1][4]>(pv2),
          [&](int row, int kk) { return pts[kk * PS + m1 + row]; },
          [&](int kk, int col) { return vs[kk * VS + n1 + col]; }, lane);
    } else {
#pragma unroll 4
      for (int s = 0; s < CL; ++s) {
        float pa[TT], va[RT];
#pragma unroll
        for (int i = 0; i < TT; ++i) pa[i] = pts[s * PS + rg * TT + i];
        load_vec(va, vs + s * VS + cg * RT);
#pragma unroll
        for (int i = 0; i < TT; ++i)
#pragma unroll
          for (int l = 0; l < RT; ++l)
            pv[i * RT + l] = fmaf(pa[i], va[l], pv[i * RT + l]);
      }
    }
    __syncthreads();
    for (int e = tid; e < CL * R; e += NT) {
      const int s = e / R;
      vs[s * VS + e - s * R] *= gs[2 * CL + s];
    }
    const float g = gs[3 * CL];

    float nqp = 0.f;   // this thread's part of n0 . q_t
    const int nq_t = tid / NQP;
    const int nq_j = (tid % NQP) * (JW / NQP);
    for (int sl = 0; sl < n_slices; ++sl) {
      const int buf = sl & 1;
      const int j0 = sl * JW;
      if (sl + 1 < n_slices) stage_slice(t0, n, j0 + JW, buf ^ 1);
      cp_async_commit();
      const float* qs = qk + buf * SM::QK;
      const float* ks = qs + CL * QS;
      // Q C0^T on the slice: qc[t][r] += sum_j q[t][j] C[r][j]
      if constexpr (TF32X3) {
        warp_mma<NT1, JW>(
            reinterpret_cast<float(&)[NT1][4]>(qc),
            reinterpret_cast<float(&)[NT1][4]>(qc2),
            [&](int row, int kk) { return qs[(m1 + row) * QS + kk]; },
            [&](int kk, int col) { return ct[(j0 + kk) * CS + n1 + col]; },
            lane);
      } else {
#pragma unroll 2
        for (int j = 0; j < JW; j += 4) {
          float qa[TT][4];
#pragma unroll
          for (int i = 0; i < TT; ++i)
            load_vec(qa[i], qs + (rg * TT + i) * QS + j);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            float ca[RT];
            load_vec(ca, ct + (j0 + j + jj) * CS + cg * RT);
#pragma unroll
            for (int i = 0; i < TT; ++i)
#pragma unroll
              for (int l = 0; l < RT; ++l)
                qc[i * RT + l] = fmaf(qa[i][jj], ca[l], qc[i * RT + l]);
          }
        }
      }
      // n0 . q_t on the slice
#pragma unroll
      for (int j = 0; j < JW / NQP; ++j)
        nqp = fmaf(nv[j0 + nq_j + j], qs[nq_t * QS + nq_j + j], nqp);
      __syncthreads();   // the slice's old C and n are read

      // C = g C + (w o v)^T k on the slice
      if constexpr (TF32X3) {
        // warp (w % WM2, w / WM2): rows r = m2.., columns j = n2..
        float cu[NT2][4], cu2[NT2][4];
#pragma unroll
        for (int i = 0; i < NT2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            cu[i][e] = g * ct[(j0 + n2 + 8 * i + 2 * fq + (e & 1)) * CS +
                              m2 + fg + 8 * (e >> 1)];
            cu2[i][e] = 0.f;
          }
        warp_mma<NT2, CL>(
            cu, cu2, [&](int row, int kk) { return vs[kk * VS + m2 + row]; },
            [&](int kk, int col) { return ks[kk * KS + n2 + col]; }, lane);
#pragma unroll
        for (int i = 0; i < NT2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ct[(j0 + n2 + 8 * i + 2 * fq + (e & 1)) * CS + m2 + fg +
               8 * (e >> 1)] = cu[i][e] + cu2[i][e];
      } else {
        // thread (rg, cg): JT columns j x RT rows r
        float cu[JT][RT];
#pragma unroll
        for (int jj = 0; jj < JT; ++jj) {
          load_vec(cu[jj], ct + (j0 + rg * JT + jj) * CS + cg * RT);
#pragma unroll
          for (int l = 0; l < RT; ++l) cu[jj][l] *= g;
        }
#pragma unroll 4
        for (int s = 0; s < CL; ++s) {
          float ka[JT], wa[RT];
          load_vec(ka, ks + s * KS + rg * JT);
          load_vec(wa, vs + s * VS + cg * RT);
#pragma unroll
          for (int jj = 0; jj < JT; ++jj)
#pragma unroll
            for (int l = 0; l < RT; ++l)
              cu[jj][l] = fmaf(wa[l], ka[jj], cu[jj][l]);
        }
#pragma unroll
        for (int jj = 0; jj < JT; ++jj)
          store_vec(ct + (j0 + rg * JT + jj) * CS + cg * RT, cu[jj]);
      }
      if (tid < JW) {
        // n = g n + sum_s w_s k_s on the slice, in four chains
        float x[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int s = 0; s < CL; ++s)
          x[s & 3] = fmaf(gs[2 * CL + s], ks[s * KS + tid], x[s & 3]);
        nv[j0 + tid] = fmaf(g, nv[j0 + tid], (x[0] + x[1]) + (x[2] + x[3]));
      }
      cp_async_wait_all();
      __syncthreads();
    }

#pragma unroll
    for (int off = 1; off < NQP; off <<= 1)
      nqp += __shfl_xor_sync(0xffffffffu, nqp, off);
    if (tid % NQP == 0) nq[nq_t] = nqp;
    __syncthreads();
    // h_t = (P V + a_t Q C0^T)_t / max(|a_t n0 . q_t + sum_s P_ts|, 1)
#pragma unroll
    for (int i = 0; i < A1; i += 2) {
      const int t = out_t(i);
      if (t < n) {
        const float a = gs[t];
        const float den = fmaxf(fabsf(fmaf(a, nq[t], gs[CL + t])), 1.f);
        const float o0 =
            fmaf(a, qc[i] + qc2[i], pv[i] + pv2[i]) / den;
        const float o1 =
            fmaf(a, qc[i + 1] + qc2[i + 1], pv[i + 1] + pv2[i + 1]) / den;
        *reinterpret_cast<float2*>(hb + (size_t)(t0 + t) * tok + out_r(i)) =
            make_float2(o0, o1);
      }
    }
    __syncthreads();   // the next chunk restages v, P^T and the gates
  }

  float* co = C_out + ((size_t)bh * DH + row0) * DH;
  for (int e = tid; e < R * (DH / 4); e += NT) {
    const int r = e % R;
    const int jq = e / R;
    *reinterpret_cast<float4*>(co + (size_t)r * DH + 4 * jq) =
        make_float4(ct[(4 * jq) * CS + r], ct[(4 * jq + 1) * CS + r],
                    ct[(4 * jq + 2) * CS + r], ct[(4 * jq + 3) * CS + r]);
  }
  if (blockIdx.x == 0)
    for (int j = tid; j < DH; j += NT) n_out[(size_t)bh * DH + j] = nv[j];
}

constexpr int MAX_DEVICES = 64;

// mlstm_chunk_state<DH, R>'s dynamic shared memory, allowed once per device
template <int DH, int R>
cudaError_t allow_state_smem() {
  static std::once_flag once[MAX_DEVICES];
  static cudaError_t result[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [dev] {
    result[dev] = cudaFuncSetAttribute(
        mlstm_chunk_state<DH, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)ChunkSmem<DH, R>::bytes);
  });
  return result[dev];
}

template <int DH>
cudaError_t launch_chunks(const float* q, const float* k, const float* v,
                          const float* ig, const float* fg, const float* C0,
                          const float* n0, const float* m0, float* h,
                          float* C, float* n, float* m, float* PT,
                          float* gates, int B, int S, int H, int has_state,
                          cudaStream_t stream) {
  constexpr int R = DH < 64 ? DH : 64;   // rows of C per CTA
  const int nc = (S + CL - 1) / CL;
  mlstm_chunk_prep<DH><<<dim3(nc, B * H), NT, 0, stream>>>(
      q, k, ig, fg, m0, PT, gates, m, S, H, nc, has_state);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t bytes = ChunkSmem<DH, R>::bytes;
  err = allow_state_smem<DH, R>();
  if (err != cudaSuccess) return err;
  mlstm_chunk_state<DH, R><<<dim3(DH / R, B * H), NT, bytes, stream>>>(
      q, k, v, C0, n0, PT, gates, h, C, n, S, H, nc, has_state);
  return cudaGetLastError();
}

}  // namespace

// The steps per chunk of the chunkwise path: S >= this takes it.
extern "C" int mlstm_scan_chunk() { return CL; }

// q, k, v, h (B, S, H, dh); ig, fg (B, S, H); C0, C (B, H, dh, dh);
// n0, n (B, H, dh); m0, m (B, H); all float32 and contiguous. C0, n0, m0
// are read only when has_state is 1 (and may be null otherwise). For
// S >= mlstm_scan_chunk() the chunkwise path runs, with scratch PT
// (B * H * nc * CL * CL floats) and gates (B * H * nc * 4 * CL floats),
// nc = ceil(S / CL), 16-byte aligned; below it the step kernel runs and
// PT, gates may be null.
extern "C" int mlstm_scan_fwd(const void* q, const void* k, const void* v,
                              const void* ig, const void* fg, const void* C0,
                              const void* n0, const void* m0, void* h,
                              void* C, void* n, void* m, void* PT,
                              void* gates, int B, int S, int H, int dh,
                              int has_state, void* stream) {
  if (B < 1 || S < 1 || H < 1 || B * H > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool chunks = S >= CL;
#define MLSTM_CASE(D)                                                        \
  case D:                                                                    \
    if (chunks)                                                              \
      return launch_chunks<D>(                                               \
          static_cast<const float*>(q), static_cast<const float*>(k),        \
          static_cast<const float*>(v), static_cast<const float*>(ig),       \
          static_cast<const float*>(fg), static_cast<const float*>(C0),      \
          static_cast<const float*>(n0), static_cast<const float*>(m0),      \
          static_cast<float*>(h), static_cast<float*>(C),                    \
          static_cast<float*>(n), static_cast<float*>(m),                    \
          static_cast<float*>(PT), static_cast<float*>(gates), B, S, H,      \
          has_state, st);                                                    \
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
