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
// Three kernels; the wrapper chooses (ops.py::kernel_for) and the C entry
// runs exactly the one it names. From CL steps up (prefill) the chunkwise-
// parallel form below runs: at dh 128 up on the Hopper kernel
// (mlstm_cluster, one cluster launch), at dh 32 and 64 on two mma.sync
// launches (the kernel "mma_sync"); under CL steps (decode is S = 1) the
// step kernel runs the recurrence as written.
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

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include <mutex>

#include "sm90_helpers.cuh"
#include "sm90_tma.cuh"

namespace {

// the kernels by the code the C entry takes (ops.py::KERNELS)
enum Kernel { STEPS = 0, MMA_SYNC = 1, SM90 = 2 };

// device launches made, by kernel code
std::atomic<long long> n_launches[3];

// err, counting one launch of the kernel code if it is cudaSuccess
cudaError_t counted(cudaError_t err, Kernel k) {
  if (err == cudaSuccess) ++n_launches[k];
  return err;
}

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
  return counted(cudaGetLastError(), STEPS);
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
// The kernel "mma_sync", two launches. mlstm_chunk_prep, one CTA
// per (chunk, batch * head), runs
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

// --- the Hopper path (sm90): the chunkwise form in one cluster launch -------
//
// One launch: CTA x of (batch, head) row y owns rows [64 x, 64 x + 64) of
// C, dh / 64 CTAs a row, in thread block clusters of CS = 2 (fewer at dh
// 64; clusters of 8 or 4 do not all fit on the card at once: 15 of 16
// and 30 of 32 at xlstm-350m's prefill, so the last ran as a second
// wave). Two consumer warpgroups, 256 threads and nothing else (a wgmma
// kernel's threads get the registers of whole warpgroups: with a producer
// warp, or a producer warpgroup and setmaxnreg, ptxas kept 168 a thread
// and C spilled); warpgroup w holds its rows of C over the 32-column
// slices i with i % 2 == w in registers (128 a thread at dh 512), from
// its load to its store. Per chunk of CL steps:
//  - the q and k slices (CL x 32 columns each, 128-byte swizzled boxes)
//    are loaded by TMA once for the cluster, multicast by its CTA 0, into
//    a ring of 4 stages; each CTA loads its own rows of v (double
//    buffered). The loads are issued by the consumers: slice L by
//    warpgroup L % 2 at the start of its slice L - 2, CTA 0 first waiting
//    until every CTA of the cluster has released slice L - 4;
//  - warpgroup w, on each of its slices: C Q^T (its part of Q C0^T,
//    transposed; A is C's columns, shuffled from the thread's registers
//    into the A fragment), n0 . q, then the update C <- g C + (w o V)^T K
//    (A = (w o V)^T from registers, B = K^T, transposed into shared
//    memory) into a fresh accumulator added to C, and n <- g n + sum w k;
//  - P = D o Q K^T is formed in the cluster: each CTA computes Q K^T over
//    half the slices, reduces its half of P's rows over both CTAs'
//    partials read through distributed shared memory, and gathers the
//    other half (two exchanges a chunk, ordered by mbarriers each CTA
//    arrives on in both; a third says the rows are gathered, since P is
//    kept in warpgroup 0's arrays of the slice loop);
//  - P V (A = V^T from registers) and the epilogue h_t = (P V + a_t Q
//    C0^T) / max(|a_t n0 . q_t + sum_s P_ts|, 1).
// Every product is wgmma m64nNk8 in 3xTF32: hi.hi + hi.lo + lo.hi, f32
// accumulate. tf32 operands in shared memory are K-major only, so the two
// products that contract over the step index take their step-major
// operand from registers (v) or as a transpose (k). A shared-memory
// operand's hi part is the f32 value itself (the tensor cores read its
// top 19 bits) and its lo part x - trunc19(x), written beside it. m's
// scalar recurrence is carried chunk to chunk in order by one thread, so
// it is exact, and every CTA forms the chunk's gate vectors itself (64
// scalars; an exchange would cost more). Shared memory at dh 512: the
// ring 64 KB, v 32 KB, each warpgroup's lo parts and K^T 32 KB (P's hi and
// lo parts over warpgroup 0's), the two partials of Q K^T 34 KB: 204 KB,
// one CTA an SM.

constexpr int SW = 32;          // floats a 128-byte swizzled row
constexpr int SJ = 32;          // columns of q and k a slice
constexpr int RING = 4;         // stages of the q, k ring
constexpr int PT = CL + 4;      // row stride of the partial Q K^T

// The float index of (row, col) in a box of rows of 32 floats laid out by
// TMA's 128-byte swizzle (the box 1024-byte aligned).
__device__ __forceinline__ int swz(int row, int col) {
  return row * SW + ((((col >> 2) ^ (row & 7)) << 2) | (col & 3));
}

// x itself, as a value the compiler cannot see through: what is computed
// from it is recomputed after this point instead of being hoisted out of
// a loop and held in registers across it
__device__ __forceinline__ int fresh(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

// The thread's indices, from tid: its warp and lane, its consumer
// warpgroup w, its thread ct and warp ww in that warpgroup, its fragment
// row group g and column pair q, and its first row fr of a 64-row tile.
#define MLSTM_THREAD(src)                                              \
  [[maybe_unused]] const int tid = fresh(src), warp = tid >> 5,        \
                             lane = tid & 31, w = warp >> 2,           \
                             ct = tid & 127, ww = warp & 3,            \
                             g = lane >> 2, q = lane & 3,              \
                             fr = 16 * ww + g

// x - trunc19(x): the part of x that a tf32 read of x drops (exact)
__device__ __forceinline__ float tf32_lo(float x) {
  return x - __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

template <int DH>
struct ClusterSmem {
  static constexpr int NCTA = DH / 64;      // CTAs a (batch, head)
  static constexpr int CS = NCTA < 2 ? NCTA : 2;   // CTAs a cluster
  static constexpr int NSL = DH / SJ;       // slices of q, k a chunk
  static constexpr int SPC = NSL / CS;      // slices of a CTA's share
  static constexpr int RPC = CL / CS;       // rows of P a CTA reduces
  // byte offsets from the 1024-aligned base
  static constexpr int RING_B = 0;                       // RING x (q, k)
  static constexpr int V_B = RING_B + RING * 16384;      // 2 x v
  static constexpr int WORK_B = V_B + 2 * 16384;         // 2 x warpgroup
  static constexpr int PH_B = WORK_B;                    // P hi, then lo,
  static constexpr int PL_B = PH_B + 16384;              // over WG 0's
  static constexpr int PART_B = WORK_B + 2 * 32768;      // 2 x Q K^T part
  static constexpr int SMALL_B = PART_B + 2 * CL * PT * 4;
  static constexpr int SMALL = 6 * CL + 2 * CL + DH + 4; // floats
  static constexpr int BAR_B = SMALL_B + SMALL * 4;
  static constexpr int BYTES = BAR_B + 16 * 8 + 1024;
};

template <int DH>
__global__ void __launch_bounds__(256, 1)
    mlstm_cluster(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const float* __restrict__ ig, const float* __restrict__ fg,
                  const float* __restrict__ C0, const float* __restrict__ n0,
                  const float* __restrict__ m0, float* __restrict__ h,
                  float* __restrict__ C_out, float* __restrict__ n_out,
                  float* __restrict__ m_out, int S, int H, int has_state) {
  using namespace repro_sm90;
  using SM = ClusterSmem<DH>;
  constexpr int CS = SM::CS, NSL = SM::NSL, SPC = SM::SPC, RPC = SM::RPC;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* bp = smem_raw + (base - smem_u32(smem_raw));
  auto fptr = [&](int off) { return reinterpret_cast<float*>(bp + off); };
  float* part = fptr(SM::PART_B);
  float* Fc = fptr(SM::SMALL_B);
  float* mc = Fc + CL;
  float* igc = mc + CL;
  float* av = igc + CL;
  float* wv = av + CL;
  float* rsum = wv + CL;
  float* nqs = rsum + CL;       // [2][CL]
  float* nv = nqs + 2 * CL;     // [DH]
  float* scal = nv + DH;        // m, the chunk's start m, g
  const uint32_t bars = base + SM::BAR_B;
  auto full = [&](int s) { return bars + 8 * s; };
  auto cempty = [&](int s) { return bars + 8 * (RING + s); };
  auto vfull = [&](int s) { return bars + 8 * (2 * RING + s); };
  const uint32_t pready = bars + 8 * (2 * RING + 2);
  const uint32_t prready = pready + 8;
  const uint32_t gdone = pready + 16;

  const int rank = (int)cluster_rank();   // in the cluster
  const int bh = blockIdx.y;
  const int b = bh / H, hd = bh - b * H;
  const int r0 = 64 * blockIdx.x;         // this CTA's rows of C
  const int tid0 = threadIdx.x;
  MLSTM_THREAD(tid0);
  const int nc = (S + CL - 1) / CL;

  if (tid == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(full(s), 1);
      mbar_init(cempty(s), CS);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(vfull(s), 1);
    }
    mbar_init(pready, CS);
    mbar_init(prready, CS);
    mbar_init(gdone, CS);
    mbar_fence_init();
  }
  __syncthreads();
  cluster_arrive();   // every barrier of the cluster is initialised
  cluster_wait();

  // The loads are issued from the consumers (a CTA of whole warpgroups
  // of consumers keeps 255 registers a thread; a producer warp would
  // leave them 168, and C would spill). Slice L (of NSL a chunk, the
  // ring's stage L % RING) is armed by each CTA's warpgroup L % 2 at the
  // start of its slice L - 2, whose stage's last slice, L - 4, that
  // warpgroup has released; CTA 0 of the cluster then waits until every
  // CTA has released slice L - 4 and multicasts q's and k's boxes.
  const uint16_t mask = (uint16_t)((1u << CS) - 1);
  auto issue_slice = [&](int L) {
    if (L >= nc * NSL) return;
    const int st = L % RING, i = L % NSL, t0 = L / NSL * CL;
    mbar_expect_tx(full(st), 16384);
    if (rank == 0) {
      if (L >= RING) mbar_wait_cluster(cempty(st), (L / RING - 1) & 1);
      const uint32_t qs = base + SM::RING_B + st * 16384;
      tma_load_4d_mc(qs, &tq, full(st), SJ * i, hd, t0, b, mask);
      tma_load_4d_mc(qs + 8192, &tk, full(st), SJ * i, hd, t0, b, mask);
    }
  };
  // v's rows of chunk c into buffer c % 2 (its last chunk, c - 2, is
  // done with it)
  auto issue_v = [&](int c) {
    if (c >= nc) return;
    const int vb = c & 1;
    mbar_expect_tx(vfull(vb), 16384);
    for (int hb = 0; hb < 2; ++hb)
      tma_load_4d(base + SM::V_B + vb * 16384 + hb * 8192, &tv, vfull(vb),
                  r0 + 32 * hb, hd, c * CL, b);
  };
  if (ct == 0) {
    issue_slice(w);
    if (w == 0) issue_v(0);
  }
  auto sync_all = [] { named_bar_sync(1, 256); };
  auto sync_wg = [&] { named_bar_sync(2 + w, 128); };
  // the slices whose Q K^T is this CTA's share: SPC of them from
  // SPC rank, those of this warpgroup's parity its share; its first one
  // stores its partial, the others add to it
  const int share0 = SPC * rank + w;
  float* part_w = part + w * (CL * PT);

  // C: warpgroup w's slices u (slice 2 u + w), m64n32 accumulators
  float creg[NSL / 2][16];
#pragma unroll
  for (int u = 0; u < NSL / 2; ++u)
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int r = fr + 8 * ((e & 3) >> 1);
      const int j = SJ * (2 * u + w) + 8 * (e >> 2) + 2 * q + (e & 1);
      creg[u][e] =
          has_state ? C0[((size_t)bh * DH + r0 + r) * DH + j] : 0.f;
    }
  for (int j = tid; j < DH; j += 256)
    nv[j] = has_state ? n0[(size_t)bh * DH + j] : 0.f;
  if (tid == 0) scal[0] = has_state ? m0[bh] : NEG_INF;

  const size_t gstride = (size_t)H;   // ig, fg: step t at [t * H]
  const float* igp = ig + (size_t)b * S * H + hd;
  const float* fgp = fg + (size_t)b * S * H + hd;
  float ign[2] = {0.f, 0.f}, fgn[2] = {0.f, 0.f};
  if (warp == 0)
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (32 * k + lane < S) {
        ign[k] = igp[(32 * k + lane) * gstride];
        fgn[k] = fgp[(32 * k + lane) * gstride];
      }

  for (int c = 0; c < nc; ++c) {
    // the indices afresh in each chunk (and each slice): addresses
    // computed from them, hoisted out of the loops, spilled C
    MLSTM_THREAD(tid0);
    const int t0 = c * CL;
    const int n = min(CL, S - t0);
    const int vb = c & 1;
    if (tid == 0) issue_v(c + 1);
    // the chunk's gates (warp 0): m by the step recurrence (lane 0),
    // F = cumsum log sigmoid(fg); a, w, g
    if (warp == 0) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        av[32 * k + lane] = log_sigmoid(fgn[k]);
        igc[32 * k + lane] = ign[k];
      }
      if (c + 1 < nc)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int t = t0 + CL + 32 * k + lane;
          ign[k] = t < S ? igp[t * gstride] : 0.f;
          fgn[k] = t < S ? fgp[t * gstride] : 0.f;
        }
      __syncwarp();
      if (lane == 0) {
        // unrolled, so that the loads run ahead of the dependent chain
        float m = scal[0], F = 0.f;
        scal[1] = m;
#pragma unroll
        for (int t = 0; t < CL; ++t) {
          if (t < n) {
            const float lf = av[t];
            m = fmaxf(lf + m, igc[t]);
            F += lf;
            Fc[t] = F;
            mc[t] = m;
          }
        }
        scal[0] = m;
      }
      __syncwarp();
      const float ms = scal[1], FL = Fc[n - 1], mL = mc[n - 1];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int t = 32 * k + lane;
        av[t] = t < n ? expf(ms + Fc[t] - mc[t]) : 0.f;
        wv[t] = t < n ? expf(igc[t] + FL - Fc[t] - mL) : 0.f;
      }
      if (lane == 0) scal[2] = expf(ms + FL - mL);
    }
    sync_all();
    const float gd = scal[2];
    mbar_wait(vfull(vb), (c >> 1) & 1);
    const float* vs = fptr(SM::V_B + vb * 16384);   // [r / 32][s][r % 32]
    // (w o V)^T or V^T as this thread's A fragment of k-step ks: rows r =
    // fr (+8), columns s = 8 ks + q (+4)
    auto v_frag = [&](int ks, bool weighted, int fr, int q,
                      uint32_t (&ah)[4], uint32_t (&al)[4]) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = fr + 8 * (e & 1);
        const int s = 8 * ks + q + 4 * (e >> 1);
        float x = vs[(r >> 5) * (CL * SW) + swz(s, r & 31)];
        if (weighted) x *= wv[s];
        split_tf32(x, ah[e], al[e]);
      }
    };

    float qc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) qc[e] = 0.f;
    float nqp = 0.f;
    const int nq_t = ct >> 1, nq_j = (ct & 1) * 16;

#pragma unroll
    for (int u = 0; u < NSL / 2; ++u) {
      MLSTM_THREAD(tid0);
      const int i = 2 * u + w;
      const int L = c * NSL + i;
      const int st = L % RING;
      if (ct == 0) issue_slice(L + 2);
      mbar_wait(full(st), (L / RING) & 1);
      const uint32_t qs_a = base + SM::RING_B + st * 16384;
      const float* qs = fptr(SM::RING_B + st * 16384);
      const float* ks = qs + 2048;
      const int wb = SM::WORK_B + w * 32768;
      float* qlo = fptr(wb);
      float* klo = fptr(wb + 8192);
      float* kth = fptr(wb + 16384);   // K^T [s / 32][j][s % 32]
      float* ktl = fptr(wb + 24576);
      const bool share = i / SPC == rank;
      if (u == 0 && w == 0 && c > 0)
        mbar_wait_cluster(gdone, (c - 1) & 1);   // P's rows, over WG 0's
                                                 // arrays, are gathered
      // the lo parts of q (and k), elementwise in the swizzled layout
      for (int e = ct; e < CL * SW / 4; e += 128) {
        const float4 x = reinterpret_cast<const float4*>(qs)[e];
        reinterpret_cast<float4*>(qlo)[e] = make_float4(
            tf32_lo(x.x), tf32_lo(x.y), tf32_lo(x.z), tf32_lo(x.w));
        if (share) {
          const float4 y = reinterpret_cast<const float4*>(ks)[e];
          reinterpret_cast<float4*>(klo)[e] = make_float4(
              tf32_lo(y.x), tf32_lo(y.y), tf32_lo(y.z), tf32_lo(y.w));
        }
      }
      // K^T, hi and lo: lanes run along s, each reading 4 columns j of
      // its row of k and writing them down column s of K^T
      for (int e = ct; e < CL * SW / 4; e += 128) {
        const int s = e & (CL - 1), jq = e / CL;
        const float4 x =
            *reinterpret_cast<const float4*>(ks + swz(s, 4 * jq));
        const float xv[4] = {x.x, x.y, x.z, x.w};
        const int d0 = (s >> 5) * (SJ * SW);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int d = d0 + swz(4 * jq + cc, s & 31);
          kth[d] = xv[cc];
          ktl[d] = tf32_lo(xv[cc]);
        }
      }
      fence_proxy_async();
      sync_wg();

      // C Q^T on the slice: A = C's columns of the slice, from the
      // accumulator: this thread needs columns q and q + 4 of each 8,
      // held by lanes 4 g + q / 2 and 4 g + 2 + q / 2 as their
      // columns 2 (q / 2) + (q & 1)
      const int src0 = (lane & ~3) | (q >> 1), src1 = src0 + 2;
      const bool odd = q & 1;
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int kp = 0; kp < 2; ++kp) {   // k-steps 2 kp, 2 kp + 1
#pragma unroll
        for (int k2 = 0; k2 < 2; ++k2) {
          const int kk = 2 * kp + k2;
          float x[4];
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const float c0 = creg[u][4 * kk + 2 * hr];
            const float c1 = creg[u][4 * kk + 2 * hr + 1];
            const float e0 = __shfl_sync(0xffffffffu, c0, src0);
            const float e1 = __shfl_sync(0xffffffffu, c1, src0);
            const float f0 = __shfl_sync(0xffffffffu, c0, src1);
            const float f1 = __shfl_sync(0xffffffffu, c1, src1);
            x[hr] = odd ? e1 : e0;          // row fr + 8 hr, column q
            x[2 + hr] = odd ? f1 : f0;      // row fr + 8 hr, column q + 4
          }
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split_tf32(x[e], ah[k2][e], al[k2][e]);
        }
        reg_fence(qc);
        wgmma_fence();
#pragma unroll
        for (int k2 = 0; k2 < 2; ++k2) {
          const int kk = 2 * kp + k2;
          const uint64_t bh_ = gmma_desc_sw128(qs_a + 32 * kk, 16);
          const uint64_t bl_ = gmma_desc_sw128(smem_u32(qlo) + 32 * kk, 16);
          wgmma_tf32_rs_n64(qc, ah[k2], bh_);
          wgmma_tf32_rs_n64(qc, ah[k2], bl_);
          wgmma_tf32_rs_n64(qc, al[k2], bh_);
        }
        wgmma_commit();
        if (kp == 0) {
          wgmma_wait<0>();
          reg_fence(qc);
        }
      }
      // n0 . q_t on the slice (the old n), beside the products
#pragma unroll
      for (int jj = 0; jj < 16; ++jj)
        nqp = fmaf(nv[SJ * i + nq_j + jj], qs[swz(nq_t, nq_j + jj)], nqp);
      wgmma_wait<0>();
      reg_fence(qc);
      if (share) {
        // no product is in flight across this branch (ptxas would
        // serialise every wgmma of the kernel)
        float sh[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) sh[e] = 0.f;
        reg_fence(sh);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t a_h = gmma_desc_sw128(qs_a + 32 * kk, 16);
          const uint64_t a_l = gmma_desc_sw128(smem_u32(qlo) + 32 * kk, 16);
          const uint64_t b_h = gmma_desc_sw128(qs_a + 8192 + 32 * kk, 16);
          const uint64_t b_l = gmma_desc_sw128(smem_u32(klo) + 32 * kk, 16);
          wgmma_tf32_ss_n64(sh, a_h, b_h);
          wgmma_tf32_ss_n64(sh, a_h, b_l);
          wgmma_tf32_ss_n64(sh, a_l, b_h);
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(sh);
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int t = fr + 8 * ((e & 3) >> 1);
          const int s_ = 8 * (e >> 2) + 2 * q + (e & 1);
          float& dst = part_w[t * PT + s_];
          dst = i == share0 ? sh[e] : dst + sh[e];
        }
      }
      sync_wg();   // the slice's old n is read

      // n <- g n + sum_s w_s k_s on the slice
      {
        const int j = ct >> 2, s0 = (ct & 3) * 16;
        float x = 0.f;
#pragma unroll
        for (int ss = 0; ss < 16; ++ss)
          x = fmaf(wv[s0 + ss], ks[swz(s0 + ss, j)], x);
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        if ((ct & 3) == 0) nv[SJ * i + j] = fmaf(gd, nv[SJ * i + j], x);
      }
      // C <- g C + (w o V)^T K on the slice: the product in a fresh
      // accumulator, then added to C (C itself is never a wgmma operand,
      // which would pin each slice's registers to the accumulator's)
      float up[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) up[e] = 0.f;
#pragma unroll
      for (int kp = 0; kp < 4; ++kp) {   // k-steps 2 kp, 2 kp + 1
#pragma unroll
        for (int k2 = 0; k2 < 2; ++k2)
          v_frag(2 * kp + k2, true, fr, q, ah[k2], al[k2]);
        reg_fence(up);
        wgmma_fence();
#pragma unroll
        for (int k2 = 0; k2 < 2; ++k2) {
          const int ks_ = 2 * kp + k2;
          const int off = (ks_ >> 2) * (SJ * SW * 4) + 32 * (ks_ & 3);
          const uint64_t b_h = gmma_desc_sw128(smem_u32(kth) + off, 16);
          const uint64_t b_l = gmma_desc_sw128(smem_u32(ktl) + off, 16);
          wgmma_tf32_rs_n32(up, ah[k2], b_h);
          wgmma_tf32_rs_n32(up, ah[k2], b_l);
          wgmma_tf32_rs_n32(up, al[k2], b_h);
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(up);
      }
#pragma unroll
      for (int e = 0; e < 16; ++e) creg[u][e] = fmaf(gd, creg[u][e], up[e]);
      sync_wg();   // the stage and the warpgroup's arrays are free
      if (ct == 0) mbar_arrive_cluster(mapa(cempty(st), 0));
    }

    // n0 . q_t: this warpgroup's part
    nqp += __shfl_xor_sync(0xffffffffu, nqp, 1);
    if ((ct & 1) == 0) nqs[w * CL + nq_t] = nqp;
    sync_all();   // the partial Q K^T is whole
    if (tid == 0) {
      fence_cluster();
      for (int rr = 0; rr < CS; ++rr) mbar_arrive_cluster(mapa(pready, rr));
    }
    mbar_wait_cluster(pready, c & 1);
    // this CTA's rows of P = D o Q K^T, summed over the cluster's
    // partials (the exponent masked before the exp); warp wp takes rows
    // wp, wp + 8, ..., lanes s = lane and lane + 32
    float* ph = fptr(SM::PH_B);
    float* pl = fptr(SM::PL_B);
    for (int tr = warp; tr < RPC; tr += 8) {
      const int t = rank * RPC + tr;
      float rs = 0.f;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int s_ = lane + 32 * k;
        float sum = 0.f;
#pragma unroll
        for (int rr = 0; rr < CS; ++rr)
#pragma unroll
          for (int wg = 0; wg < 2; ++wg)
            sum += ld_dsmem(
                mapa(smem_u32(part + wg * (CL * PT) + t * PT + s_), rr));
        const float p = t < n && s_ <= t
                            ? expf(igc[s_] + Fc[t] - Fc[s_] - mc[t]) * sum
                            : 0.f;
        const int d = k * (CL * SW) + swz(t, lane);
        ph[d] = p;
        pl[d] = tf32_lo(p);
        rs += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      if (lane == 0) rsum[t] = rs;
    }
    sync_all();
    if (tid == 0) {
      fence_cluster();
      for (int rr = 0; rr < CS; ++rr)
        mbar_arrive_cluster(mapa(prready, rr));
    }
    mbar_wait_cluster(prready, c & 1);
    // the other CTAs' rows of P (hi and lo, both boxes: 128 bytes each a
    // row) and their row sums
    for (int e = tid; e < (CS - 1) * RPC * 32; e += 256) {
      const int row = e >> 5, part_ = e & 31;
      int rr = row / RPC;
      rr += rr >= rank;
      const int t = rr * RPC + row % RPC;
      const int off = (part_ >> 4) * 16384 + ((part_ >> 3) & 1) * 8192 +
                      t * 128 + (part_ & 7) * 16;
      const float4 x = ld_dsmem4(mapa(base + SM::PH_B + off, rr));
      *reinterpret_cast<float4*>(bp + SM::PH_B + off) = x;
    }
    for (int e = tid; e < (CS - 1) * RPC; e += 256) {
      int rr = e / RPC;
      rr += rr >= rank;
      const int t = rr * RPC + e % RPC;
      rsum[t] = ld_dsmem(mapa(smem_u32(rsum + t), rr));
    }
    fence_proxy_async();
    sync_all();
    if (tid == 0) {   // this CTA is done reading the others' rows of P
      fence_cluster();
      for (int rr = 0; rr < CS; ++rr) mbar_arrive_cluster(mapa(gdone, rr));
    }

    // P V on this warpgroup's half of t: A = V^T, B = P [t][s]
    float pv[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) pv[e] = 0.f;
    {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int kp = 0; kp < 4; ++kp) {   // k-steps 2 kp, 2 kp + 1
#pragma unroll
        for (int k2 = 0; k2 < 2; ++k2)
          v_frag(2 * kp + k2, false, fr, q, ah[k2], al[k2]);
        reg_fence(pv);
        wgmma_fence();
#pragma unroll
        for (int k2 = 0; k2 < 2; ++k2) {
          const int ks_ = 2 * kp + k2;
          const int off =
              (ks_ >> 2) * (CL * SW * 4) + w * 32 * 128 + 32 * (ks_ & 3);
          const uint64_t b_h = gmma_desc_sw128(base + SM::PH_B + off, 16);
          const uint64_t b_l = gmma_desc_sw128(base + SM::PL_B + off, 16);
          wgmma_tf32_rs_n32(pv, ah[k2], b_h);
          wgmma_tf32_rs_n32(pv, ah[k2], b_l);
          wgmma_tf32_rs_n32(pv, al[k2], b_h);
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(pv);
      }
    }
    // Q C0^T: each warpgroup's share of the j sum, exchanged by halves of
    // t through the partial's buffer (every CTA is done reading it)
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int jt = e >> 2;   // 8-column block of t
      if ((jt >> 2) != w) {
        const int r = fr + 8 * ((e & 3) >> 1);
        part[r * PT + 8 * jt + 2 * q + (e & 1)] = qc[e];
      }
    }
    sync_all();
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = fr + 8 * (e >> 1);
        const int t = 32 * w + 8 * jj + 2 * q + (e & 1);
        if (t < n) {
          const float a = av[t];
          const float qct = qc[4 * (4 * w + jj) + e] + part[r * PT + t];
          const float den = fmaxf(
              fabsf(fmaf(a, nqs[t] + nqs[CL + t], rsum[t])), 1.f);
          h[(((size_t)b * S + t0 + t) * H + hd) * DH + r0 + r] =
              fmaf(a, qct, pv[4 * jj + e]) / den;
        }
      }
    sync_all();   // v, the partial's buffer and the gates are free
  }

#pragma unroll
  for (int u = 0; u < NSL / 2; ++u)
#pragma unroll
    for (int e = 0; e < 16; e += 2) {
      const int r = fr + 8 * ((e & 3) >> 1);
      const int j = SJ * (2 * u + w) + 8 * (e >> 2) + 2 * q;
      *reinterpret_cast<float2*>(C_out + ((size_t)bh * DH + r0 + r) * DH +
                                 j) = make_float2(creg[u][e], creg[u][e + 1]);
    }
  if (blockIdx.x == 0) {
    for (int j = tid; j < DH; j += 256) n_out[(size_t)bh * DH + j] = nv[j];
    if (tid == 0) m_out[bh] = scal[0];
  }
  cluster_arrive();   // no CTA leaves while another may still address it
  cluster_wait();
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
  if (PT == nullptr || gates == nullptr) return cudaErrorInvalidValue;
  const int nc = (S + CL - 1) / CL;
  mlstm_chunk_prep<DH><<<dim3(nc, B * H), NT, 0, stream>>>(
      q, k, ig, fg, m0, PT, gates, m, S, H, nc, has_state);
  cudaError_t err = counted(cudaGetLastError(), MMA_SYNC);
  if (err != cudaSuccess) return err;
  constexpr size_t bytes = ChunkSmem<DH, R>::bytes;
  err = allow_state_smem<DH, R>();
  if (err != cudaSuccess) return err;
  mlstm_chunk_state<DH, R><<<dim3(DH / R, B * H), NT, bytes, stream>>>(
      q, k, v, C0, n0, PT, gates, h, C, n, S, H, nc, has_state);
  return counted(cudaGetLastError(), MMA_SYNC);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once through the runtime
// (so the library needs no link against libcuda); null if absent.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The 4-D map (dh, H, S, B), innermost first, over an f32 tensor in the
// model layout (B, S, H, dh): boxes of 32 columns (128 bytes) x 1 head x
// CL steps x 1 batch row, 128-byte swizzled; steps past S read as zeros.
cudaError_t make_map(CUtensorMap* map, const float* ptr, int dh, int H,
                     int S, int B) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)dh * 4, (cuuint64_t)H * dh * 4,
                                 (cuuint64_t)S * H * dh * 4};
  const cuuint32_t box[4] = {SW, 1, CL, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the Hopper kernel: one cluster of DH / 64 CTAs per (batch, head)
template <int DH>
cudaError_t launch_cluster(const float* q, const float* k, const float* v,
                           const float* ig, const float* fg, const float* C0,
                           const float* n0, const float* m0, float* h,
                           float* C, float* n, float* m, int B, int S, int H,
                           int has_state, cudaStream_t stream) {
  using SM = ClusterSmem<DH>;
  CUtensorMap mq, mk, mv;
  cudaError_t err = make_map(&mq, q, DH, H, S, B);
  if (err == cudaSuccess) err = make_map(&mk, k, DH, H, S, B);
  if (err == cudaSuccess) err = make_map(&mv, v, DH, H, S, B);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mlstm_cluster<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SM::BYTES);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(SM::NCTA, B * H);
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = SM::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = SM::CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, mlstm_cluster<DH>, mq, mk, mv, ig, fg, C0,
                           n0, m0, h, C, n, m, S, H, has_state);
  if (err != cudaSuccess) return err;
  return counted(cudaGetLastError(), SM90);
}

template <int DH>
cudaError_t launch_kernel(int kernel, const float* q, const float* k,
                          const float* v, const float* ig, const float* fg,
                          const float* C0, const float* n0, const float* m0,
                          float* h, float* C, float* n, float* m, float* PT,
                          float* gates, int B, int S, int H, int has_state,
                          cudaStream_t stream) {
  if (kernel == STEPS)
    return launch<DH>(q, k, v, ig, fg, C0, n0, m0, h, C, n, m, B, S, H,
                      has_state, stream);
  if (S < CL) return cudaErrorInvalidValue;   // the chunkwise kernels
  if (kernel == MMA_SYNC)
    return launch_chunks<DH>(q, k, v, ig, fg, C0, n0, m0, h, C, n, m, PT,
                             gates, B, S, H, has_state, stream);
  if constexpr (DH >= 128) {
    if (kernel == SM90)
      return launch_cluster<DH>(q, k, v, ig, fg, C0, n0, m0, h, C, n, m, B,
                                S, H, has_state, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// The steps per chunk of the chunkwise kernels: they take S >= this.
extern "C" int mlstm_scan_chunk() { return CL; }

// The device launches this library has made of the kernel code's kernels
// (the two-launch kernel counts two a call); -1 for another code.
extern "C" long long mlstm_scan_device_launches(int kernel) {
  return kernel >= 0 && kernel < 3 ? n_launches[kernel].load() : -1;
}

// How many clusters of the Hopper kernel at head dim dh fit on the current
// card at once (cudaOccupancyMaxActiveClusters), or a negative error.
extern "C" int mlstm_scan_max_clusters(int dh) {
  int n = 0;
  cudaError_t err = cudaErrorInvalidValue;
  const auto query = [&](auto kernel, int ncta, int cs, int bytes) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(ncta, 1024);
    cfg.blockDim = dim3(256);
    cfg.dynamicSmemBytes = bytes;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  };
  if (dh == 128)
    query(mlstm_cluster<128>, 2, ClusterSmem<128>::CS,
          ClusterSmem<128>::BYTES);
  if (dh == 256)
    query(mlstm_cluster<256>, 4, ClusterSmem<256>::CS,
          ClusterSmem<256>::BYTES);
  if (dh == 512)
    query(mlstm_cluster<512>, 8, ClusterSmem<512>::CS,
          ClusterSmem<512>::BYTES);
  return err == cudaSuccess ? n : -(int)err;
}

// q, k, v, h (B, S, H, dh); ig, fg (B, S, H); C0, C (B, H, dh, dh);
// n0, n (B, H, dh); m0, m (B, H); all float32 and contiguous (q, k, v
// 16-byte aligned). C0, n0, m0 are read only when has_state is 1 (and
// may be null otherwise). kernel (ops.py::kernel_for): 0 = the step
// kernel (any S), 1 = the two mma.sync chunkwise launches (S >=
// mlstm_scan_chunk(), with scratch PT (B * H * nc * CL * CL floats) and
// gates (B * H * nc * 4 * CL floats), nc = ceil(S / CL), 16-byte
// aligned), 2 = the Hopper kernel (S >= mlstm_scan_chunk(), dh 128, 256
// or 512, one cluster launch, no scratch; PT, gates may be null). Any
// other combination is cudaErrorInvalidValue, never another kernel.
extern "C" int mlstm_scan_fwd(const void* q, const void* k, const void* v,
                              const void* ig, const void* fg, const void* C0,
                              const void* n0, const void* m0, void* h,
                              void* C, void* n, void* m, void* PT,
                              void* gates, int kernel, int B, int S, int H,
                              int dh, int has_state, void* stream) {
  if (B < 1 || S < 1 || H < 1 || B * H > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MLSTM_CASE(D)                                                       \
  case D:                                                                   \
    return launch_kernel<D>(                                                \
        kernel, static_cast<const float*>(q), static_cast<const float*>(k), \
        static_cast<const float*>(v), static_cast<const float*>(ig),        \
        static_cast<const float*>(fg), static_cast<const float*>(C0),       \
        static_cast<const float*>(n0), static_cast<const float*>(m0),       \
        static_cast<float*>(h), static_cast<float*>(C),                     \
        static_cast<float*>(n), static_cast<float*>(m),                     \
        static_cast<float*>(PT), static_cast<float*>(gates), B, S, H,       \
        has_state, st);
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
