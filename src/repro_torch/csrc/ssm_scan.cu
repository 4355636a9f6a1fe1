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
// Two kernels; the wrapper chooses (ops.py::kernel_for) and the C entry
// runs exactly the one it names. From CL steps up (prefill) the Hopper
// kernel (ssd_cluster, one cluster launch) runs the chunked form below;
// under CL steps (decode is S = 1) the step kernel runs the recurrence as
// written.
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include <type_traits>

#include "sm90_helpers.cuh"
#include "sm90_tma.cuh"

namespace {

// device launches made, by kernel code (0 steps, 1 sm90)
std::atomic<long long> n_launches[2];

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

// --- the chunked form (state-space duality) ---------------------------------
//
// For S >= CL steps the scan runs in chunks of CL steps. Per (batch, head)
// and chunk, with cum_t the sum of dt_s A over the chunk's steps up to t
// and S0 the state at the chunk's start:
//   y_t = sum_{s<=t} exp(cum_t - cum_s) (C_t . B_s) dt_s x_s
//         + exp(cum_t) S0 C_t + D x_t
//   S   = exp(cum_L) S0 + sum_s exp(cum_L - cum_s) dt_s x_s B_s^T
// with the exponent masked to s <= t before the exp (exp(+large) * 0 is
// NaN). The decay is one scalar per (batch, step, head) and B_t, C_t are
// shared by the heads. Only the state crosses chunks, so all but the
// state's pass over the chunks is parallel. The products (about 8.5 K
// flops per (batch, head, step)) run as mma.sync m16n8k8 tiles in
// 3xTF32, close to f32's accuracy.

constexpr int CL = 32;     // steps per chunk

using repro_sm90::warp_mma;

// a pair of y values of type TX
__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a,
                                       float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// --- the Hopper path (sm90): the chunked form in one cluster launch ---------
//
// One thread block cluster per (head, batch) row, of n = min(8, nc) CTAs
// (8 is the portable cluster size): CTA r of the cluster takes chunks
// [r nc / n, (r + 1) nc / n), its span. Each CTA, in one launch:
//  A. folds its span's chunks into one summary, a P x N increment and a
//     scalar decay: per chunk, with dA = exp(cum_L) and dS the chunk's
//     increment (wdt o X)^T B, Sspan <- dA Sspan + dS, Aspan <- dA Aspan
//     (the decay composed as a product of per-chunk decays, never one
//     long cumulative sum);
//  B. publishes the summary in its shared memory, and after a cluster
//     barrier composes its start state from the earlier CTAs' summaries,
//     read through distributed shared memory: S <- A_j S + Sspan_j for
//     j < r, at most 7 hops of one P x N FMA;
//  C. computes its chunks' y from that state and carries the state on
//     chunk to chunk; the last CTA writes the final state.
// No chunk state reaches device memory (the states at every chunk's start
// would be B Hs nc P N floats, 13 MB at hymba-1.5b's prefill).
// A producer warp feeds a ring of ST5 stages on mbarriers: x's chunk box
// (CL x P of x's type), B's and C's (CL x N) by TMA, and dt's CL values by
// its lanes (dt's row stride, Hs floats, need not be a multiple of 16
// bytes, as TMA requires). The chunks are taken in groups of ST5, one a
// stage, and a group's chunks are worked on together: the per-chunk
// chain (decays, increments, M, y) runs once a group with a handful of
// barriers, not once a chunk. A span of at most ST5 chunks (hymba-1.5b's
// prefill: 4) is one group and stays resident for pass C; a longer span
// is loaded twice (the second time from L2). Eight consumer warps: warp w
// owns one m16n8 tile of the P x N state and holds it, and its chunks'
// increments, in registers; y's (CL / 16) x (P / 8) tiles of every chunk
// of the group are shared out; the products are mma.sync 3xTF32
// warp tiles (a chunk of 32 steps is below wgmma's 64 rows). Steps past S
// are loaded as zeros (TMA's out-of-bounds fill, dt 0), so they leave the
// state as it is. One head a CTA: at hymba-1.5b's prefill (B 4, S 1024,
// Hs 25) that is 800 CTAs of 4 chunks each.

constexpr int CLUSTER = 8;   // CTAs per cluster at most (portable limit)
constexpr int ST5 = 4;       // ring stages, and chunks a group
constexpr int C_THREADS = 256;   // consumer threads (8 warps)

template <typename TX, int N>
struct RingSm90 {
  static constexpr int X_BYTES = CL * MAX_P * (int)sizeof(TX);
  static constexpr int BC_BYTES = CL * N * 4;
  static constexpr int STAGE = X_BYTES + 2 * BC_BYTES + CL * 4;
  static constexpr int MS = CL + 4;               // row stride of M
  static constexpr int SS = N + 4;                // row stride of a state
  static constexpr int ST = MAX_P * SS;           // a chunk's start state
  static constexpr int MM = CL * MS;              // a chunk's M
  // floats after the ring and its barriers: per chunk of the group its
  // start state, M, cum, wdt and exp(cum), and dA; the summary
  static constexpr int FLOATS =
      ST5 * (ST + MM + 3 * CL + 1) + MAX_P * N + 4;
  static constexpr int BYTES = ST5 * STAGE + 2 * ST5 * 8 + 4 * FLOATS + 128;
};

template <typename TX, typename TW, int N>
__global__ void __launch_bounds__(C_THREADS + 32, 2)
    ssd_cluster(const __grid_constant__ CUtensorMap tmx,
                const __grid_constant__ CUtensorMap tmb,
                const __grid_constant__ CUtensorMap tmc,
                const float* __restrict__ dt, const TW* __restrict__ a_log,
                const TW* __restrict__ d_skip,
                const float* __restrict__ state0, TX* __restrict__ y,
                float* __restrict__ state, int S, int Hs, int P,
                int has_state) {
  using namespace repro_sm90;
  using RS = RingSm90<TX, N>;
  constexpr int MS = RS::MS, SS = RS::SS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 127) & ~127u;
  unsigned char* ring_p = smem_raw + (ring - smem_u32(smem_raw));
  const uint32_t bars = ring + ST5 * RS::STAGE;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (ST5 + s); };
  float* stg = reinterpret_cast<float*>(ring_p + ST5 * RS::STAGE + 16 * ST5);
  float* mmg = stg + ST5 * RS::ST;     // [k][CL][MS]: M of chunk k
  float* cumg = mmg + ST5 * RS::MM;    // [k][CL]
  float* wdtg = cumg + ST5 * CL;       // [k][CL]
  float* ecg = wdtg + ST5 * CL;        // [k][CL]
  float* dAg = ecg + ST5 * CL;         // [k]
  float* summ = dAg + ST5;             // [P * N] the span's increment,
  float* summ_a = summ + MAX_P * N;    // then its decay (published)
  auto stage_x = [&](int s) {
    return reinterpret_cast<const TX*>(ring_p + s * RS::STAGE);
  };
  auto stage_b = [&](int s) {
    return reinterpret_cast<const float*>(ring_p + s * RS::STAGE +
                                          RS::X_BYTES);
  };
  auto stage_c = [&](int s) { return stage_b(s) + CL * N; };
  auto stage_dt = [&](int s) {
    return reinterpret_cast<float*>(ring_p + s * RS::STAGE + RS::X_BYTES +
                                    2 * RS::BC_BYTES);
  };

  const int rank = blockIdx.x, n_ctas = gridDim.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nc = (S + CL - 1) / CL;
  const int c_begin = rank * nc / n_ctas;
  const int cpc = (rank + 1) * nc / n_ctas - c_begin;
  const bool resident = cpc <= ST5;
  const size_t tok0 = (size_t)b * S;

  if (tid == 0) {
    for (int s = 0; s < ST5; ++s) {
      mbar_init(full(s), 33);     // the expect_tx arrival + 32 dt lanes
      mbar_init(empty(s), C_THREADS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == C_THREADS / 32) {
    // the producer warp: its lanes also take part in both cluster
    // barriers (the first it passes at once: it publishes nothing)
    cluster_arrive();
    const int n_loads = resident ? cpc : 2 * cpc;
    const uint32_t bytes = CL * P * sizeof(TX) + 2 * RS::BC_BYTES;
    for (int i = 0; i < n_loads; ++i) {
      const int s = i % ST5;
      if (i >= ST5) mbar_wait(empty(s), (i / ST5 - 1) & 1);
      const int t0 = (c_begin + i % cpc) * CL;
      if (lane == 0) {
        const uint32_t xs = ring + s * RS::STAGE;
        mbar_expect_tx(full(s), bytes);
        tma_load_4d(xs, &tmx, full(s), 0, h, t0, b);
        tma_load_3d(xs + RS::X_BYTES, &tmb, full(s), 0, t0, b);
        tma_load_3d(xs + RS::X_BYTES + RS::BC_BYTES, &tmc, full(s), 0, t0,
                    b);
      }
      const int t = t0 + lane;
      stage_dt(s)[lane] = t < S ? dt[(tok0 + t) * Hs + h] : 0.f;
      mbar_arrive(full(s));
    }
    cluster_wait();
    cluster_arrive();
    cluster_wait();
    return;
  }

  const float A = -expf(to_f(a_log[h]));
  const float D = to_f(d_skip[h]);
  // x in bf16 is exact in TF32: products with it need no lo part
  constexpr bool X_EXACT = sizeof(TX) == 2;
  const int mt = P / 16;
  const bool has_tile = warp < mt * (N / 8);
  const int p0 = 16 * (warp % mt), n0 = 8 * (warp / mt);
  const int g = lane >> 2, q = lane & 3;
  auto sync = [] { named_bar_sync(1, C_THREADS); };
  // this warp's element e of a state tile: row p0 + g + 8 (e / 2),
  // column n0 + 2 q + e % 2
  auto tile_at = [&](int e) {
    return (p0 + g + 8 * (e >> 1)) * SS + n0 + 2 * q + (e & 1);
  };
  const int n_groups = (cpc + ST5 - 1) / ST5;
  auto group_size = [&](int gi) { return min(ST5, cpc - ST5 * gi); };

  // the group's chunks' decays, chunk k by warp k: cum_t = sum of dt A to
  // t in step order (lane 0, as the plain version's cumsum; dt is 0 past
  // S, so the sum keeps its value), wdt, exp(cum), dA = exp(cum_L)
  auto gates = [&](int nk, int load0) {
    if (warp < nk) {
      const float* dts = stage_dt((load0 + warp) % ST5);
      float* cum = cumg + warp * CL;
      if (lane == 0) {
        float acc = 0.f;
#pragma unroll
        for (int t = 0; t < CL; ++t) {
          acc += dts[t] * A;
          cum[t] = acc;
        }
      }
      __syncwarp();
      const float cL = cum[CL - 1];
      wdtg[warp * CL + lane] = expf(cL - cum[lane]) * dts[lane];
      ecg[warp * CL + lane] = expf(cum[lane]);
      if (lane == 0) dAg[warp] = expf(cL);
    }
    sync();
  };
  // this warp's tile of each chunk's increment (wdt o X)^T B
  float ds[ST5][4];
  auto increments = [&](int nk, int load0) {
    if (!has_tile) return;
#pragma unroll
    for (int k = 0; k < ST5; ++k) {
      if (k >= nk) break;
      const int s = (load0 + k) % ST5;
      const TX* xs = stage_x(s);
      const float* bs = stage_b(s);
      const float* wd = wdtg + k * CL;
      float acc[1][4] = {{0.f, 0.f, 0.f, 0.f}};
      float cor[1][4] = {{0.f, 0.f, 0.f, 0.f}};
      warp_mma<1, CL, X_EXACT, false>(
          acc, cor, [&](int row, int kk) { return to_f(xs[kk * P + p0 + row]); },
          [&](int kk, int col) { return wd[kk] * bs[kk * N + n0 + col]; },
          lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[k][e] = acc[0][e] + cor[0][e];
    }
  };
  auto wait_group = [&](int nk, int load0) {
    for (int k = 0; k < nk; ++k)
      mbar_wait(full((load0 + k) % ST5), ((load0 + k) / ST5) & 1);
  };
  auto release_group = [&](int nk, int load0) {
    __syncwarp();
    if (lane == 0)
      for (int k = 0; k < nk; ++k) mbar_arrive(empty((load0 + k) % ST5));
  };

  // A: the span's summary
  float run[4] = {0.f, 0.f, 0.f, 0.f};
  float aspan = 1.f;
  for (int gi = 0; gi < n_groups; ++gi) {
    const int nk = group_size(gi), load0 = ST5 * gi;
    wait_group(nk, load0);
    gates(nk, load0);
    increments(nk, load0);
#pragma unroll
    for (int k = 0; k < ST5; ++k) {
      if (k >= nk) break;
      const float dA = dAg[k];
#pragma unroll
      for (int e = 0; e < 4; ++e) run[e] = fmaf(dA, run[e], ds[k][e]);
      aspan *= dA;
    }
    if (!resident) {
      sync();   // the group's stages and gates are the next group's
      release_group(nk, load0);
    }
  }

  // B: publish the summary, then compose the start state
  if (has_tile)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      summ[(p0 + g + 8 * (e >> 1)) * N + n0 + 2 * q + (e & 1)] = run[e];
  if (tid == 0) *summ_a = aspan;
  cluster_arrive();
  cluster_wait();
  const size_t bh = (size_t)b * Hs + h;
  for (int e = tid; e < P * N / 4; e += C_THREADS) {
    float4 v = has_state
                   ? reinterpret_cast<const float4*>(state0 + bh * P * N)[e]
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    // every load in flight at once (ranks past this one's are read
    // from this CTA and left unused)
    float a[CLUSTER - 1];
    float4 u[CLUSTER - 1];
#pragma unroll
    for (int j = 0; j < CLUSTER - 1; ++j) {
      const int jr = j < rank ? j : rank;
      a[j] = ld_dsmem(mapa(smem_u32(summ_a), jr));
      u[j] = ld_dsmem4(mapa(smem_u32(summ + 4 * e), jr));
    }
#pragma unroll
    for (int j = 0; j < CLUSTER - 1; ++j)
      if (j < rank) {
        v.x = fmaf(a[j], v.x, u[j].x);
        v.y = fmaf(a[j], v.y, u[j].y);
        v.z = fmaf(a[j], v.z, u[j].z);
        v.w = fmaf(a[j], v.w, u[j].w);
      }
    const int p = 4 * e / N, n = 4 * e - p * N;
    *reinterpret_cast<float4*>(&stg[p * SS + n]) = v;
  }
  cluster_arrive();   // done with the other CTAs' shared memory
  sync();
  if (has_tile)
#pragma unroll
    for (int e = 0; e < 4; ++e) run[e] = stg[tile_at(e)];
  sync();   // stg is the group's

  // y = M X + (exp(cum) o C) S^T + D x of the group's chunks, over tiles
  // of 16 steps x 8 NTL columns of P, shared out to the warps
  auto y_tiles = [&](auto ntl, int nk, int load0, int chunk0) {
    constexpr int NTL = decltype(ntl)::value;
    const int tpc = (CL / 16) * (P / (8 * NTL));   // tiles a chunk
    for (int task = warp; task < nk * tpc; task += C_THREADS / 32) {
      const int k = task / tpc, tile = task - k * tpc;
      const int m0 = 16 * (tile % (CL / 16));
      const int c0 = 8 * NTL * (tile / (CL / 16));
      const int s = (load0 + k) % ST5;
      const TX* xs = stage_x(s);
      const float* cs = stage_c(s);
      const float* mm = mmg + k * RS::MM;
      const float* st = stg + k * RS::ST;
      const float* ec = ecg + k * CL;
      const int chunk = chunk0 + k;
      const int n = min(CL, S - chunk * CL);
      float acc[NTL][4] = {}, cor[NTL][4] = {};
      warp_mma<NTL, CL, false, X_EXACT>(
          acc, cor, [&](int row, int kk) { return mm[(m0 + row) * MS + kk]; },
          [&](int kk, int col) { return to_f(xs[kk * P + c0 + col]); },
          lane);
      warp_mma<NTL, N>(
          acc, cor,
          [&](int row, int kk) {
            return ec[m0 + row] * cs[(m0 + row) * N + kk];
          },
          [&](int kk, int col) { return st[(c0 + col) * SS + kk]; }, lane);
#pragma unroll
      for (int i = 0; i < NTL; ++i) {
        const int p = c0 + 8 * i + 2 * q;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int t = m0 + g + 8 * r;
          if (t < n)
            store2(y + ((tok0 + chunk * CL + t) * Hs + h) * P + p,
                   fmaf(D, to_f(xs[t * P + p]),
                        acc[i][2 * r] + cor[i][2 * r]),
                   fmaf(D, to_f(xs[t * P + p + 1]),
                        acc[i][2 * r + 1] + cor[i][2 * r + 1]));
        }
      }
    }
  };

  // C: the span's y, group by group, the state carried chunk to chunk
  for (int gi = 0; gi < n_groups; ++gi) {
    const int nk = group_size(gi);
    const int load0 = resident ? ST5 * gi : cpc + ST5 * gi;
    const int chunk0 = c_begin + ST5 * gi;
    if (!resident) {
      wait_group(nk, load0);
      gates(nk, load0);
      increments(nk, load0);
    }
    // each chunk's start state (this warp's tile)
    if (has_tile)
#pragma unroll
      for (int k = 0; k < ST5; ++k) {
        if (k >= nk) break;
        const float dA = dAg[k];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          stg[k * RS::ST + tile_at(e)] = run[e];
          run[e] = fmaf(dA, run[e], ds[k][e]);
        }
      }
    sync();
    // M_ts = (C_t . B_s) exp(cum_t - cum_s) dt_s for s <= t < n, else 0
    // (the exponent masked before the exp): C B^T on the tensor cores,
    // a 16 x 32 tile a task, then the mask and the decay per element
    for (int task = warp; task < nk * (CL / 16); task += C_THREADS / 32) {
      const int k = task / (CL / 16), m0 = 16 * (task % (CL / 16));
      const int s = (load0 + k) % ST5;
      const float* cs = stage_c(s);
      const float* bs = stage_b(s);
      const float* dts = stage_dt(s);
      const float* cum = cumg + k * CL;
      const int n = min(CL, S - (chunk0 + k) * CL);
      float acc[CL / 8][4] = {}, cor[CL / 8][4] = {};
      warp_mma<CL / 8, N>(
          acc, cor, [&](int row, int kk) { return cs[(m0 + row) * N + kk]; },
          [&](int kk, int col) { return bs[col * N + kk]; }, lane);
#pragma unroll
      for (int i = 0; i < CL / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = m0 + g + 8 * (e >> 1), u = 8 * i + 2 * q + (e & 1);
          float v = 0.f;
          if (u <= t && t < n)
            v = (acc[i][e] + cor[i][e]) * expf(cum[t] - cum[u]) * dts[u];
          mmg[k * RS::MM + t * MS + u] = v;
        }
    }
    sync();
    if (P % 32 == 0)
      y_tiles(std::integral_constant<int, 4>{}, nk, load0, chunk0);
    else
      y_tiles(std::integral_constant<int, 2>{}, nk, load0, chunk0);
    sync();   // the group's stages and arrays are the next group's
    if (!resident) release_group(nk, load0);
  }
  if (rank == n_ctas - 1 && has_tile)
#pragma unroll
    for (int e = 0; e < 4; e += 2)
      *reinterpret_cast<float2*>(
          state + (bh * P + p0 + g + 4 * e) * N + n0 + 2 * q) =
          make_float2(run[e], run[e + 1]);
  cluster_wait();   // no CTA leaves while another may read its summary
}

// the pointers and sizes of one call
struct Args {
  const void *x, *dt, *a_log, *b, *c, *d_skip, *state0;
  void *y, *state;
  int B, S, Hs, P, has_state;
  cudaStream_t stream;
};

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

// A map over a contiguous tensor of `rank` dims (innermost first) whose
// boxes are `box`, unswizzled; out-of-bounds elements read as zeros.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int rank,
                     const cuuint64_t* dims, const cuuint32_t* box,
                     int esize, CUtensorMapDataType type) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  cuuint64_t strides[4];
  cuuint64_t stride = esize;
  for (int d = 0; d + 1 < rank; ++d) strides[d] = stride *= dims[d];
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, type, rank, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the kernels by the code the C entry takes (ops.py::KERNELS)
enum Kernel { STEPS = 0, SM90 = 1 };

// err, counting one launch of the kernel code if it is cudaSuccess
cudaError_t counted(cudaError_t err, Kernel k) {
  if (err == cudaSuccess) ++n_launches[k];
  return err;
}

template <typename TX, typename TW, int N>
cudaError_t launch_steps(const Args& a) {
  ssm_scan_kernel<TX, TW, N>
      <<<dim3(a.Hs, a.B), a.P * (N / 4), 0, a.stream>>>(
          static_cast<const TX*>(a.x), static_cast<const float*>(a.dt),
          static_cast<const TW*>(a.a_log), static_cast<const float*>(a.b),
          static_cast<const float*>(a.c), static_cast<const TW*>(a.d_skip),
          static_cast<const float*>(a.state0), static_cast<TX*>(a.y),
          static_cast<float*>(a.state), a.S, a.Hs, a.P, a.has_state);
  return counted(cudaGetLastError(), STEPS);
}

// the Hopper kernel (the kernel "sm90"): one cluster launch
template <typename TX, typename TW, int N>
cudaError_t launch_sm90(const Args& a) {
  using RS = RingSm90<TX, N>;
  const CUtensorMapDataType tx_type =
      sizeof(TX) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap mx, mb, mc;
  const cuuint64_t xdims[4] = {(cuuint64_t)a.P, (cuuint64_t)a.Hs,
                               (cuuint64_t)a.S, (cuuint64_t)a.B};
  const cuuint32_t xbox[4] = {(cuuint32_t)a.P, 1, CL, 1};
  const cuuint64_t bdims[3] = {N, (cuuint64_t)a.S, (cuuint64_t)a.B};
  const cuuint32_t bbox[3] = {N, CL, 1};
  cudaError_t err =
      make_map(&mx, a.x, 4, xdims, xbox, sizeof(TX), tx_type);
  if (err == cudaSuccess)
    err = make_map(&mb, a.b, 3, bdims, bbox, 4,
                   CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (err == cudaSuccess)
    err = make_map(&mc, a.c, 3, bdims, bbox, 4,
                   CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_cluster<TX, TW, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               RS::BYTES);
  if (err != cudaSuccess) return err;
  const int nc = (a.S + CL - 1) / CL;
  const int n_ctas = nc < CLUSTER ? nc : CLUSTER;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_ctas, a.Hs, a.B);
  cfg.blockDim = dim3(C_THREADS + 32);
  cfg.dynamicSmemBytes = RS::BYTES;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, ssd_cluster<TX, TW, N>, mx, mb, mc,
      static_cast<const float*>(a.dt), static_cast<const TW*>(a.a_log),
      static_cast<const TW*>(a.d_skip), static_cast<const float*>(a.state0),
      static_cast<TX*>(a.y), static_cast<float*>(a.state), a.S, a.Hs, a.P,
      a.has_state);
  if (err != cudaSuccess) return err;
  return counted(cudaGetLastError(), SM90);
}

template <typename TX, typename TW, int N>
cudaError_t launch(const Args& a, int kernel) {
  if (kernel == STEPS) return launch_steps<TX, TW, N>(a);
  if (kernel == SM90 && a.S >= CL) return launch_sm90<TX, TW, N>(a);
  return cudaErrorInvalidValue;
}

template <typename TX, typename TW>
cudaError_t launch_n(const Args& a, int kernel, int N) {
  if (N == 8) return launch<TX, TW, 8>(a, kernel);
  if (N == 16) return launch<TX, TW, 16>(a, kernel);
  return cudaErrorInvalidValue;
}

template <typename TX>
cudaError_t launch_w(const Args& a, int kernel, int w_dtype, int N) {
  if (w_dtype == 0) return launch_n<TX, float>(a, kernel, N);
  if (w_dtype == 1) return launch_n<TX, __nv_bfloat16>(a, kernel, N);
  return cudaErrorInvalidValue;
}

}  // namespace

// The steps per chunk of the chunked kernels: they take S >= this.
extern "C" int ssm_scan_chunk() { return CL; }

// The device launches this library has made of the kernel code's kernel;
// -1 for another code.
extern "C" long long ssm_scan_device_launches(int kernel) {
  return kernel >= 0 && kernel < 2 ? n_launches[kernel].load() : -1;
}

// x, y (B, S, Hs, P) of type x_dtype (0 float32, 1 bfloat16); dt
// (B, S, Hs), b, c (B, S, N) and state0, state (B, Hs, P, N) float32;
// a_log, d_skip (Hs,) of type w_dtype. All contiguous, and x, b, c and
// the states 16-byte aligned. P a multiple of 16 up to 64, N 8 or 16.
// state0 is read only when has_state is 1 (and may be null otherwise).
// kernel (ops.py::kernel_for): 0 = the step kernel (any S), 1 = the
// Hopper kernel (S >= ssm_scan_chunk(), one cluster launch). Any other
// combination is cudaErrorInvalidValue, never another kernel.
extern "C" int ssm_scan_fwd(const void* x, const void* dt, const void* a_log,
                            const void* b, const void* c, const void* d_skip,
                            const void* state0, void* y, void* state,
                            int kernel, int x_dtype, int w_dtype, int B,
                            int S, int Hs, int P, int N, int has_state,
                            void* stream) {
  if (B < 1 || B > 65535 || S < 1 || Hs < 1 || Hs > 65535 || P < 16 ||
      P > MAX_P || P % 16 != 0)
    return cudaErrorInvalidValue;
  const Args a{x,     dt, a_log, b,  c,        d_skip,
               state0, y,  state, B,  S,        Hs,
               P,      has_state, static_cast<cudaStream_t>(stream)};
  if (x_dtype == 0) return launch_w<float>(a, kernel, w_dtype, N);
  if (x_dtype == 1) return launch_w<__nv_bfloat16>(a, kernel, w_dtype, N);
  return cudaErrorInvalidValue;
}
