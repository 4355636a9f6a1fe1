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
// Three kernels, chosen by the element type and the head dim
// (ops.py::kernel_for; a fixed dispatch, not a fallback):
//
// bfloat16 at dh 64 and 128 (every served arch with attention):
// flash_fwd_bf16_sm90, on Hopper's own instructions. A query tile is 64
// rows for each consumer warpgroup (two at dh 128, three at dh 64); one
// CTA an SM works through the tiles, heaviest causal tiles first. One
// thread of a producer warpgroup loads Q and a ring of K and V blocks (128
// keys; 112 at dh 64) by TMA (cp.async.bulk.tensor over 4-D tensor maps
// (dh, heads, S, B), 128-byte swizzle, so the tail block past S is
// zero-filled and never reads the next batch row) and synchronises with
// mbarriers: a full barrier a stage that the loads complete, an empty
// one that each consumer warpgroup arrives on once it is done with the
// stage. setmaxnreg hands the producer's registers to the consumers. Both
// products are wgmma.mma_async, bf16 in, f32 accumulate: S = Q K^T with Q
// and K from shared memory (K-major), O += P V with P from registers (the
// f32 scores repacked to bf16 in the A fragment layout) and V from shared
// memory, MN-major by the transpose bit. In each warpgroup block i's
// Q K^T is issued with block i - 1's P V; the warpgroups take turns to
// issue (named barriers), so one's products run while another computes
// its softmax. Blocks masked for a
// whole warpgroup are skipped by it; blocks masked for the whole tile are
// not loaded.
//
// bfloat16 at dh 32 and 256: flash_fwd_bf16, FlashAttention-2's dataflow
// on mma.sync. One CTA of four warps per (query block, query head, batch
// row); each warp owns 16 query rows. Both products run on
// mma.sync.m16n8k16 (bf16 in, f32 accumulate) with operands loaded by
// ldmatrix from shared-memory tiles whose rows are padded by 16 bytes, so
// the eight rows of an 8x8 matrix fall in eight distinct bank groups. K
// and V tiles of BK keys sit in a ring of two stages filled by cp.async
// one tile ahead of the mmas. Scores and probabilities never leave
// registers, P is repacked from the f32 accumulator fragment into the
// bf16 A fragment of P.V, and the mask is evaluated only on key blocks
// that straddle it.
//
// float32: flash_fwd_f32, the SIMT kernel of the first port (one CTA of
// 128 threads per 64-row query block, 32-key blocks, f32 tiles in shared
// memory, products on FMAs). The tensor-core route for f32 is TF32,
// whose 10-bit mantissa would not keep the f32 results within 2e-5 of
// the plain version.
//
// Both read kv head h / G for query head h from the model layout
// (B, S, heads, dh), so GQA needs no copy of K or V. As in the reference,
// scores are f32 and scaled, masked scores are the finite -1e30 (a row
// that meets a block in which all its keys are masked accumulates exp(0)
// that a later alpha = 0 wipes, where -inf would give NaN), l sums the
// unrounded f32 p, p is rounded to the input type before p @ V, and the
// output is acc / max(l, 1e-30).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_helpers.cuh"
#include "sm90_tma.cuh"

namespace {

using namespace repro_sm90;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// --- float32: the SIMT kernel ------------------------------------------------

constexpr int BQ = 64;   // query rows per CTA
constexpr int BK = 32;   // keys per inner block
constexpr int NT = 128;  // threads per CTA

template <int DH>
constexpr size_t smem_floats() {
  return (size_t)BQ * (DH + 1) + (size_t)BK * (DH + 1) + (size_t)BK * DH +
         (size_t)BQ * (BK + 1) + 3 * BQ;
}

template <int DH>
__global__ void __launch_bounds__(NT)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int Sq,
                  int Sk, int H, int KV, int causal, int window,
                  float scale) {
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
    Qs[r * QS + d] = qi < Sq ? q[((size_t)(b * Sq + qi) * H + h) * DH + d]
                             : 0.f;
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
      Ks[r * QS + d] = ok ? k[off] : 0.f;
      Vs[r * DH + d] = ok ? v[off] : 0.f;
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
      for (int i = 0; i < 4; ++i) p[i] = Ss[(ty + 16 * i) * SS + c];
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
    float* orow = o + ((size_t)(b * Sq + qi) * H + h) * DH;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) orow[tx + 8 * j] = acc[i][j] / l;
  }
}

template <int DH>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int Sq, int Sk, int H, int KV, int causal,
                       int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<DH>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_f32<DH><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, H, KV,
      causal, window, scale);
  return cudaGetLastError();
}

// --- bfloat16: the tensor-core kernel -----------------------------------------

using bf16 = __nv_bfloat16;

// Tile sizes per head dim: NW warps of MT 16-row m-tiles (each K and V
// fragment feeds MT mmas), BK keys per block, Q's fragments in registers
// or re-read from shared memory. A warp holds MT x 16 x dh of f32 output
// accumulator and MT x 16 x BK of scores; the sizes below are the ones
// that measured fastest on the H100 among those that do not spill.
template <int DH>
struct TileBf16 {
  static constexpr int NW = 4;
  static constexpr int MT = DH == 64 || DH == 128 ? 2 : 1;
  static constexpr int BK = DH >= 128 ? 32 : 64;
  static constexpr bool Q_IN_REGS = DH <= 64;
};

// ROWS rows of DH bf16 from global (row r at src + r * stride, rows at or
// past n_rows zero-filled) into a shared tile of padded row stride DH + 8.
template <int ROWS, int DH, int NTH>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          size_t stride, int row0,
                                          int n_rows, int tid) {
  constexpr int CPR = DH / 8;  // 16-byte chunks per row
  static_assert((ROWS * CPR) % NTH == 0, "tile chunks split evenly");
#pragma unroll
  for (int it = 0; it < ROWS * CPR / NTH; ++it) {
    const int i = tid + it * NTH;
    const int r = i / CPR, c = i % CPR;
    const bool ok = row0 + r < n_rows;
    const bf16* s = src + (size_t)(ok ? row0 + r : 0) * stride + c * 8;
    cp_async16(smem_u32(dst + r * (DH + 8) + c * 8), s, ok);
  }
}

template <int DH>
__global__ void __launch_bounds__(TileBf16<DH>::NW * 32)
    flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o, int Sq,
                   int Sk, int H, int KV, int causal, int window,
                   float scale_log2) {
  using TL = TileBf16<DH>;
  constexpr int NW = TL::NW, MT = TL::MT, WR = 16 * MT;  // rows a warp
  constexpr int BQ_ = WR * NW, BK_ = TL::BK, NTH = NW * 32;
  constexpr int RS = DH + 8;   // padded row stride, elements
  constexpr int KD = DH / 16;  // k-steps of Q K^T
  constexpr int NS = BK_ / 8;  // 8-key n-tiles of S
  constexpr int ND = DH / 8;   // 8-column n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // BQ_ x RS
  bf16* Ks = Qs + BQ_ * RS;                       // 2 stages x BK_ x RS
  bf16* Vs = Ks + 2 * BK_ * RS;                   // 2 stages x BK_ x RS

  // heaviest causal query blocks first: blockIdx.y is the slower grid dim
  const int qb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int kvh = h / (H / KV);
  const int q0 = qb * BQ_;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row group, column pair

  const size_t q_stride = (size_t)H * DH, kv_stride = (size_t)KV * DH;
  const bf16* qbase = q + ((size_t)b * Sq * H + h) * DH;
  const bf16* kbase = k + ((size_t)b * Sk * KV + kvh) * DH;
  const bf16* vbase = v + ((size_t)b * Sk * KV + kvh) * DH;

  // key blocks that hold a valid key for some row of this query block
  const int q_hi = min(q0 + BQ_, Sq) - 1;
  int kb_end = (Sk + BK_ - 1) / BK_;
  if (causal) kb_end = min(kb_end, q_hi / BK_ + 1);
  const int kb_begin = window > 0 ? max(0, q0 - window + 1) / BK_ : 0;

  // key block kb_begin + j goes to stage j % 2
  auto load_kv = [&](int kb, int st) {
    load_tile<BK_, DH, NTH>(Ks + st * BK_ * RS, kbase, kv_stride, kb * BK_,
                            Sk, tid);
    load_tile<BK_, DH, NTH>(Vs + st * BK_ * RS, vbase, kv_stride, kb * BK_,
                            Sk, tid);
  };
  load_tile<BQ_, DH, NTH>(Qs, qbase, q_stride, q0, Sq, tid);
  if (kb_begin < kb_end) load_kv(kb_begin, 0);
  cp_async_commit();

  // this warp's rows; m-tile mt's fragment rows are wq0 + 16 mt + g (+ 8)
  const int wq0 = q0 + warp * WR;
  const int wq_hi = min(wq0 + WR - 1, Sq - 1);
  const bool warp_live = wq0 < Sq;

  // ldmatrix row addresses: Q (A, x4: rows 0-15, k 0-7 then 8-15), K (B,
  // x4: keys 0-7 k 0-7, keys 0-7 k 8-15, keys 8-15 k 0-7, keys 8-15 k
  // 8-15), V (B, x4 transposed: keys 0-7 d 0-7, keys 8-15 d 0-7, keys 0-7
  // d 8-15, keys 8-15 d 8-15)
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int k_row = (lane & 7) + (lane >> 4) * 8, k_col = ((lane >> 3) & 1) * 8;
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8, v_col = (lane >> 4) * 8;
  const uint32_t q_addr = smem_u32(Qs + (warp * WR + a_row) * RS + a_col);

  uint32_t qf[TL::Q_IN_REGS ? MT : 1][TL::Q_IN_REGS ? KD : 1][4];
  float acc[MT][ND][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
  float m[MT][2], l[MT][2];  // running max (log2 units); this thread's
#pragma unroll               // share of the row sums
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mt][r] = NEG_INF;
      l[mt][r] = 0.f;
    }

  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int st = (kb - kb_begin) & 1;
    if (kb + 1 < kb_end) load_kv(kb + 1, st ^ 1);  // into the other stage
    cp_async_commit();
    cp_async_wait<1>();  // this block's (and Q's) copies have landed
    __syncthreads();
    if constexpr (TL::Q_IN_REGS) {
      if (kb == kb_begin) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int kk = 0; kk < KD; ++kk)
            ldsm_x4(qf[mt][kk], q_addr + (mt * 16 * RS + kk * 16) * 2);
      }
    }

    const int k0 = kb * BK_;
    const bool skip = !warp_live || (causal && k0 > wq_hi) ||
                      (window > 0 && k0 + BK_ - 1 <= wq0 - window);
    if (!skip) {
      const bf16* Kt = Ks + st * BK_ * RS;
      const bf16* Vt = Vs + st * BK_ * RS;
      float s[MT][NS][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if constexpr (TL::Q_IN_REGS) {
#pragma unroll
            for (int e = 0; e < 4; ++e) a[mt][e] = qf[mt][kk][e];
          } else {
            ldsm_x4(a[mt], q_addr + (mt * 16 * RS + kk * 16) * 2);
          }
        }
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t bb[4];
          ldsm_x4(bb, smem_u32(Kt + (np * 16 + k_row) * RS + kk * 16 + k_col));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][2 * np], a[mt], bb[0], bb[1]);
            mma_bf16(s[mt][2 * np + 1], a[mt], bb[2], bb[3]);
          }
        }
      }

      // A block that straddles the mask holds scores scaled into log2
      // units with masked ones at -1e30 (sc = 1); any other block keeps
      // the raw products and folds the scale into exp2's argument.
      const bool full = k0 + BK_ <= Sk && (!causal || k0 + BK_ - 1 <= wq0) &&
                        (window == 0 || k0 > wq_hi - window);
      const float sc = full ? scale_log2 : 1.f;
      if (!full) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = k0 + 8 * j + 2 * t + (e & 1);
              const int row = wq0 + 16 * mt + g + (e < 2 ? 0 : 8);
              bool ok = key < Sk;
              if (causal) ok = ok && key <= row;
              if (window > 0) ok = ok && key > row - window;
              s[mt][j][e] = ok ? s[mt][j][e] * scale_log2 : NEG_INF;
            }
      }

      uint32_t pa[MT][NS / 2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          mx[0] = fmaxf(mx[0], fmaxf(s[mt][j][0], s[mt][j][1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[mt][j][2], s[mt][j][3]));
        }
        float neg_m[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[mt][r], mx[r] * sc);
          const float alpha = ex2(m[mt][r] - m_new);
          m[mt][r] = m_new;
          neg_m[r] = -m_new;
          l[mt][r] *= alpha;
#pragma unroll
          for (int j = 0; j < ND; ++j) {
            acc[mt][j][2 * r] *= alpha;
            acc[mt][j][2 * r + 1] *= alpha;
          }
        }
        // p in f32 into l; rounded to bf16 into the A fragments of P.V
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float p0 = ex2(fmaf(s[mt][j][0], sc, neg_m[0]));
          const float p1 = ex2(fmaf(s[mt][j][1], sc, neg_m[0]));
          const float p2 = ex2(fmaf(s[mt][j][2], sc, neg_m[1]));
          const float p3 = ex2(fmaf(s[mt][j][3], sc, neg_m[1]));
          l[mt][0] += p0 + p1;
          l[mt][1] += p2 + p3;
          pa[mt][j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
          pa[mt][j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
        }
      }
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk)
#pragma unroll
        for (int dp = 0; dp < ND / 2; ++dp) {
          uint32_t bb[4];
          ldsm_x4_t(bb, smem_u32(Vt + (kk * 16 + v_row) * RS + dp * 16 + v_col));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mt][2 * dp], pa[mt][kk], bb[0], bb[1]);
            mma_bf16(acc[mt][2 * dp + 1], pa[mt][kk], bb[2], bb[3]);
          }
        }
    }
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();

  if (!warp_live) return;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[mt][r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      lr = fmaxf(lr, 1e-30f);
      const int row = wq0 + 16 * mt + g + 8 * r;
      if (row >= Sq) continue;
      bf16* orow = o + ((size_t)(b * Sq + row) * H + h) * DH + 2 * t;
#pragma unroll
      for (int j = 0; j < ND; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack_bf16(acc[mt][j][2 * r] / lr, acc[mt][j][2 * r + 1] / lr);
    }
}

template <int DH>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int Sq, int Sk, int H, int KV, int causal,
                        int window, float scale, cudaStream_t stream) {
  using TL = TileBf16<DH>;
  constexpr int BQ_ = 16 * TL::MT * TL::NW;
  const size_t smem = sizeof(bf16) * (BQ_ + 4 * TL::BK) * (DH + 8);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + BQ_ - 1) / BQ_);
  flash_fwd_bf16<DH><<<grid, TL::NW * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Sq, Sk, H, KV,
      causal, window, scale * LOG2E);
  return cudaGetLastError();
}

// --- bfloat16 at dh 64 and 128: the Hopper kernel ----------------------------

// A query tile is BQ rows of one (batch row, query head): CONSUMERS
// warpgroups of 64 rows each. A CTA of those warpgroups and a producer
// warpgroup works through query tiles one after another (one CTA an SM).
// BK keys a block, STAGES blocks of K and V in the ring; HALVES 64-column
// (128-byte) boxes a row of dh. At entry ptxas gives every thread 65536 /
// THREADS registers (168 or 128); the producer warpgroup keeps P_REGS of
// them and hands the rest to the consumers (C_REGS).
template <int DH>
struct TileSm90 {
  static constexpr int CONSUMERS = DH == 64 ? 3 : 2;
  static constexpr int THREADS = 128 * (CONSUMERS + 1);
  static constexpr int P_REGS = CONSUMERS == 3 ? 32 : 40;
  static constexpr int C_REGS = CONSUMERS == 3 ? 160 : 232;
  static constexpr int BQ = 64 * CONSUMERS;
  // 112 keys at dh 64: the scores of 128 would not fit in C_REGS
  static constexpr int BK = DH == 64 ? 112 : 128;
  static constexpr int STAGES = DH == 64 ? 4 : 3;
  static constexpr int HALVES = DH / 64;
  static constexpr int Q_BYTES = BQ * DH * 2;
  static constexpr int KV_BYTES = BK * DH * 2;  // K or V, one stage
  // the tiles, their 1024-byte alignment, and the 2 + 2 STAGES barriers
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 1024 +
                              8 * (2 + 2 * STAGES);
};

// Query tile t of n_tiles = n_qt * B * H: causal tiles heaviest first.
// Its key blocks [kb_begin, kb_begin + n_blocks) are those that hold a
// valid key for some row of the tile.
struct QueryTile {
  int q0, h, b, kb_begin, n_blocks;
  __device__ QueryTile(int t, int n_qt, int bq, int bk, int Sq, int Sk,
                       int H, int BH, int causal, int window) {
    const int qb = causal ? n_qt - 1 - t / BH : t / BH;
    h = t % BH % H;
    b = t % BH / H;
    q0 = qb * bq;
    const int q_hi = min(q0 + bq, Sq) - 1;
    int kb_end = (Sk + bk - 1) / bk;
    if (causal) kb_end = min(kb_end, q_hi / bk + 1);
    kb_begin = window > 0 ? max(0, q0 - window + 1) / bk : 0;
    n_blocks = max(0, kb_end - kb_begin);
  }
};

template <int DH>
__global__ void __launch_bounds__(TileSm90<DH>::THREADS, 1)
    flash_fwd_bf16_sm90(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        bf16* __restrict__ o, int B, int Sq, int Sk, int H,
                        int KV, int causal, int window, float scale_log2) {
  using TL = TileSm90<DH>;
  constexpr int BK_ = TL::BK, ST = TL::STAGES, HV = TL::HALVES;
  constexpr int NC = TL::CONSUMERS;
  constexpr int Q_HALF = TL::BQ * 128, KV_HALF = BK_ * 128;  // bytes a box
  constexpr int NS = BK_ / 8;  // 8-key column tiles of S
  constexpr int ND = DH / 8;   // 8-column tiles of O
  extern __shared__ unsigned char smem_raw[];
  // Q's boxes, then stage s's K boxes at kv0 + 2 s KV_BYTES and its V
  // boxes after them, then the barriers: Q full, Q empty, STAGES full,
  // STAGES empty
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t kv0 = q_s + TL::Q_BYTES;
  const uint32_t q_full = kv0 + 2 * ST * TL::KV_BYTES, q_empty = q_full + 8;
  auto full = [&](int s) { return q_full + 8 * (2 + s); };
  auto empty = [&](int s) { return q_full + 8 * (2 + ST + s); };
  auto k_stage = [&](int s) { return kv0 + 2 * s * TL::KV_BYTES; };

  const int n_qt = (Sq + TL::BQ - 1) / TL::BQ, BH = B * H;
  const int n_tiles = n_qt * BH;
  auto tile = [&](int t) {
    return QueryTile(t, n_qt, TL::BQ, BK_, Sq, Sk, H, BH, causal, window);
  };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, NC);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), NC);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * NC) {
    // the producer warpgroup: its first thread issues every load. A
    // tile's first key block is loaded before its Q, which waits until
    // every consumer is done with the previous tile's.
    setmaxnreg_dec<TL::P_REGS>();
    if (tid != 128 * NC) return;
    int it = 0;  // blocks loaded so far: block it goes to stage it % ST
    int n = 0;   // tiles loaded so far
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++n) {
      const QueryTile qt = tile(t);
      const int kvh = qt.h / (H / KV);
      for (int i = 0; i <= qt.n_blocks; ++i) {
        if (i == min(1, qt.n_blocks)) {
          if (n > 0) mbar_wait(q_empty, (n - 1) & 1);
          mbar_expect_tx(q_full, TL::Q_BYTES);
          for (int hv = 0; hv < HV; ++hv)
            tma_load_4d(q_s + hv * Q_HALF, &tq, q_full, 64 * hv, qt.h, qt.q0,
                        qt.b);
        }
        if (i == qt.n_blocks) break;
        const int s = it % ST;
        // the stage's previous block released by every consumer
        if (it >= ST) mbar_wait(empty(s), (it / ST - 1) & 1);
        const uint32_t ks = k_stage(s), vs = ks + TL::KV_BYTES;
        const int k0 = (qt.kb_begin + i) * BK_;
        mbar_expect_tx(full(s), 2 * TL::KV_BYTES);
        for (int hv = 0; hv < HV; ++hv) {
          tma_load_4d(ks + hv * KV_HALF, &tk, full(s), 64 * hv, kvh, k0,
                      qt.b);
          tma_load_4d(vs + hv * KV_HALF, &tv, full(s), 64 * hv, kvh, k0,
                      qt.b);
        }
        ++it;
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns query rows wq0 .. wq0 + 63 of each
  // tile; this thread holds rows row0 and row0 + 8 of them
  setmaxnreg_inc<TL::C_REGS>();
  const int wg = warp / 4;
  const int g = lane / 4, t4 = lane % 4;
  const uint32_t q_wg = q_s + 64 * 128 * wg;  // this warpgroup's 64 rows

  float acc[DH / 2];       // O, unnormalised
  float sacc[4 * NS];      // S of one block, then its p in f32
  uint32_t pa[NS / 2][4];  // p in bf16: the A fragments of P V
  float m[2], l[2];        // l: this thread's share of the row sums
  float alpha[2];          // the factor O is to be rescaled by

  // Ping-pong: the warpgroups take turns, in a ring, to issue their
  // products (warpgroup w waits at named barrier 1 + w and then lets the
  // next one go), so that one's products run on the tensor cores while the
  // other computes its softmax. In each tile each takes n_blocks + 1
  // turns, issuing nothing in the turns of blocks it skips; warpgroup 0
  // goes first, and the last one's last turn lets no one go.
  int turn = 0, last_turn = -1;
  auto begin_turn = [&]() { named_bar_sync(1 + wg, 256); };
  auto end_turn = [&]() {
    if (wg != NC - 1 || turn != last_turn)
      named_bar_arrive(1 + (wg + 1) % NC, 256);
    ++turn;
  };
  if (wg == NC - 1) named_bar_arrive(1, 256);

  int it0 = 0;  // ring index of the tile's first block
  int n = 0;    // tiles done
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++n) {
    const QueryTile qt = tile(t);
    const int kb_begin = qt.kb_begin, n_blocks = qt.n_blocks;
    const int wq0 = qt.q0 + 64 * wg;
    const int wq_hi = min(wq0 + 63, Sq - 1);
    const int row0 = wq0 + 16 * (warp % 4) + g;
    if (t + gridDim.x >= n_tiles) last_turn = turn + n_blocks;

    // this warpgroup's blocks [i_lo, i_hi) of the tile's n_blocks: those
    // masked for all its rows lie at either end (before the window, past
    // the causal diagonal); a warpgroup past Sq has none. It takes and
    // hands back the others unread.
    auto masked_out = [&](int i) {
      const int k0 = (kb_begin + i) * BK_;
      return wq0 >= Sq || (causal && k0 > wq_hi) ||
             (window > 0 && k0 + BK_ - 1 <= wq0 - window);
    };
    int i_lo = 0, i_hi = n_blocks;
    while (i_lo < i_hi && masked_out(i_lo)) ++i_lo;
    while (i_hi > i_lo && masked_out(i_hi - 1)) --i_hi;
    auto acquire = [&](int i) {
      const int r = it0 + i;
      mbar_wait(full(r % ST), (r / ST) & 1);
    };
    auto release = [&](int i) {
      if (tid % 128 == 0) mbar_arrive(empty((it0 + i) % ST));
    };
    auto skip_block = [&](int i) {
      acquire(i);
      begin_turn();
      end_turn();
      release(i);
    };

    // S = Q K^T: both K-major, 16 columns of dh a product
    auto issue_qk = [&](int i) {
      const uint32_t ks = k_stage((it0 + i) % ST);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // within the 128-byte row
        const uint64_t dq =
            gmma_desc_sw128(q_wg + (kk / 4) * Q_HALF + off, 16);
        const uint64_t dk =
            gmma_desc_sw128(ks + (kk / 4) * KV_HALF + off, 16);
        if constexpr (BK_ == 112)
          wgmma_ss_n112(sacc, dq, dk, kk > 0);
        else
          wgmma_ss_n128(sacc, dq, dk, kk > 0);
      }
    };
    // O += P V: P from registers, V MN-major (dh contiguous), 16 keys a
    // product
    auto issue_pv = [&](int i) {
      const uint32_t vs = k_stage((it0 + i) % ST) + TL::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        const uint64_t dv = gmma_desc_sw128(vs + kk * 16 * 128, KV_HALF);
        if constexpr (DH == 64)
          wgmma_rs_n64_tb(acc, pa[kk], dv, 1);
        else
          wgmma_rs_n128_tb(acc, pa[kk], dv, 1);
      }
    };
    // the online softmax of block i's scores, in place: m, l and alpha
    // updated, p in f32 in sacc
    auto softmax = [&](int i) {
      const int k0 = (kb_begin + i) * BK_;
      // A block that straddles the mask holds scores scaled into log2
      // units with masked ones at -1e30 (sc = 1); any other block keeps
      // the raw products and folds the scale into exp2's argument.
      const bool whole = k0 + BK_ <= Sk &&
                         (!causal || k0 + BK_ - 1 <= wq0) &&
                         (window == 0 || k0 > wq_hi - window);
      const float sc = whole ? scale_log2 : 1.f;
      if (!whole) {
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + 2 * t4 + (e & 1);
            const int row = row0 + (e < 2 ? 0 : 8);
            bool ok = key < Sk;
            if (causal) ok = ok && key <= row;
            if (window > 0) ok = ok && key > row - window;
            sacc[4 * j + e] = ok ? sacc[4 * j + e] * scale_log2 : NEG_INF;
          }
      }
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(sacc[4 * j], sacc[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
      }
      float neg_m[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * sc);
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
        neg_m[r] = -m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(sacc[4 * j + e], sc, neg_m[e / 2]));
          l[e / 2] += p;  // the unrounded p
          sacc[4 * j + e] = p;
        }
    };
    // O rescaled by alpha; p rounded to bf16 into the A fragments of P V
    auto rescale_and_pack = [&]() {
#pragma unroll
      for (int j = 0; j < ND; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * j + e] *= alpha[e / 2];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        pa[j / 2][(j & 1) * 2] = pack_bf16(sacc[4 * j], sacc[4 * j + 1]);
        pa[j / 2][(j & 1) * 2 + 1] =
            pack_bf16(sacc[4 * j + 2], sacc[4 * j + 3]);
      }
    };
    auto fence_operands = [&]() {
      reg_fence(acc);
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) reg_fence(pa[kk]);
      wgmma_fence();
    };

#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
    m[0] = m[1] = NEG_INF;
    l[0] = l[1] = 0.f;
    mbar_wait(q_full, n & 1);
    for (int i = 0; i < i_lo; ++i) skip_block(i);
    if (i_lo < i_hi) {
      // Block i's Q K^T and block i - 1's P V are issued in one turn, and
      // O is rescaled once P V is done with it. (ptxas places the wait
      // for P V before block i's softmax, so the softmax overlaps the
      // other warpgroups' products, not this one's.)
      acquire(i_lo);
      begin_turn();
      wgmma_fence();
      issue_qk(i_lo);
      wgmma_commit();
      end_turn();
      wgmma_wait<0>();
      reg_fence(sacc);
      softmax(i_lo);
      rescale_and_pack();
      for (int i = i_lo + 1; i < i_hi; ++i) {
        acquire(i);
        begin_turn();
        fence_operands();
        issue_qk(i);
        wgmma_commit();
        issue_pv(i - 1);
        wgmma_commit();
        end_turn();
        wgmma_wait<1>();  // Q K^T of block i done
        reg_fence(sacc);
        softmax(i);
        wgmma_wait<0>();  // P V of block i - 1 done: its stage is free
        reg_fence(acc);
        release(i - 1);
        rescale_and_pack();
      }
      begin_turn();
      fence_operands();
      issue_pv(i_hi - 1);
      wgmma_commit();
      end_turn();
      wgmma_wait<0>();
      reg_fence(acc);
      release(i_hi - 1);
    } else {
      begin_turn();  // the turn of the last P V
      end_turn();
    }
    for (int i = i_hi; i < n_blocks; ++i) skip_block(i);
    // every product of this tile is done: Q's buffer is free
    if (tid % 128 == 0) mbar_arrive(q_empty);
    it0 += n_blocks;

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      lr = fmaxf(lr, 1e-30f);
      const int row = row0 + 8 * r;
      if (row >= Sq) continue;
      bf16* orow = o + ((size_t)(qt.b * Sq + row) * H + qt.h) * DH + 2 * t4;
#pragma unroll
      for (int j = 0; j < ND; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack_bf16(acc[4 * j + 2 * r] / lr, acc[4 * j + 2 * r + 1] / lr);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once through the runtime
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

// The 4-D map (dh, heads, S, B), innermost first, over a bf16 tensor in
// the model layout (B, S, heads, dh): boxes of 64 columns (128 bytes, the
// swizzle's span) x 1 head x rows x 1 batch row, 128-byte swizzled.
// Keeping S and B apart makes TMA zero-fill a box's rows past S instead of
// reading the next batch row.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int dh, int heads,
                     int S, int B, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)dh * 2,
                                 (cuuint64_t)heads * dh * 2,
                                 (cuuint64_t)S * heads * dh * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DH>
cudaError_t launch_sm90(const void* q, const void* k, const void* v, void* o,
                        int B, int Sq, int Sk, int H, int KV, int causal,
                        int window, float scale, cudaStream_t stream) {
  using TL = TileSm90<DH>;
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map(&tq, q, DH, H, Sq, B, TL::BQ);
  if (err == cudaSuccess) err = make_map(&tk, k, DH, KV, Sk, B, TL::BK);
  if (err == cudaSuccess) err = make_map(&tv, v, DH, KV, Sk, B, TL::BK);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_fwd_bf16_sm90<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               TL::SMEM);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return err;
  // one CTA an SM, each taking every gridDim-th query tile
  const int n_tiles = (Sq + TL::BQ - 1) / TL::BQ * B * H;
  flash_fwd_bf16_sm90<DH><<<min(n_tiles, sms), TL::THREADS, TL::SMEM,
                            stream>>>(tq, tk, tv, static_cast<bf16*>(o), B,
                                      Sq, Sk, H, KV, causal, window,
                                      scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, dh), k/v (B, Sk, KV, dh), o (B, Sq, H, dh), all contiguous
// (bf16: 16-byte aligned). kernel (ops.py::kernel_for): 0 = the float32
// SIMT kernel (dh 32, 64, 128, 256), 1 = the bf16 mma.sync kernel (dh 32,
// 256), 2 = the bf16 Hopper kernel (dh 64, 128); any other combination is
// cudaErrorInvalidValue, never another kernel. Returns the launch's
// cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int kernel, int B,
                                   int Sq, int Sk, int H, int KV, int dh,
                                   int causal, int window, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(K, D, LAUNCH) \
  if (kernel == K && dh == D)    \
    return LAUNCH<D>(q, k, v, o, B, Sq, Sk, H, KV, causal, window, scale, s);
  FLASH_CASE(0, 32, launch_f32)
  FLASH_CASE(0, 64, launch_f32)
  FLASH_CASE(0, 128, launch_f32)
  FLASH_CASE(0, 256, launch_f32)
  FLASH_CASE(1, 32, launch_bf16)
  FLASH_CASE(1, 256, launch_bf16)
  FLASH_CASE(2, 64, launch_sm90)
  FLASH_CASE(2, 128, launch_sm90)
#undef FLASH_CASE
  return cudaErrorInvalidValue;
}
