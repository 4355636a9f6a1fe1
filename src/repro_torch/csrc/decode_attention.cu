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
// the ~295 flops per byte where the tensor cores would bind. At serving
// sizes the cache is 4-84 MB, most of it no more than the card can have in
// flight at once, so what a kernel can do is put the bytes in flight
// early and keep the work around the loads short. Per launch the host
// does no more than the launch itself (and, for decode_sm90, encodes its
// two tensor maps): the kernels work out each slot's position from (pos,
// S, ring), and the kernels' attributes are set once per kernel and
// device, not at every call.
//
// The TPU kernel walks the cache of one (batch, kv head) row in one
// sequential pass; here B*KV is only 8-160 rows at serving sizes against
// 132 SMs, so the cache is split across CTAs (split-K), one thread block
// cluster per row merging through distributed shared memory. Both kernels
// read each cache row once for the G query heads that share it, and skip
// tiles with no valid slot (never written, in the future, or outside the
// window) without reading them. Masking and the final acc / max(l, 1e-30)
// follow the reference; a warp, CTA or rank with no valid slot merges as
// (m = -1e30, l = 0, acc = 0), which adds nothing and no NaN.
//
// Two kernels, chosen by q's type and the head dim (ops.py::kernel_for; a
// fixed dispatch, not a fallback):
//
// bf16 q at dh 64 and 128 (every served arch): decode_sm90, on Hopper's
// own data path. A cluster of up to 16 CTAs a row (clusters above 8 are
// non-portable; the plan asks cudaOccupancyMaxActiveClusters which sizes
// fit in one wave). Each CTA takes whole 32-slot tiles; one producer warp
// loads each tile that has a valid slot by TMA (4-D tensor maps over the
// (B, S, KV, dh) cache, boxes of one kv head's 32 rows, 128-byte swizzle,
// 64-byte for int8 rows of 64 bytes; slots past S zero-filled) into a
// ring of up to 64 KB on full/empty mbarriers, and for K3 its lanes copy
// the tile's 32 k and 32 v scales by cp.async, which arrives on the same
// barrier. A partly valid tile is loaded whole and masked in the pass
// (its other slots hold the cache's own values; p = 0 there, as in the
// reference's masked blocks). Four consumer warps take the tiles in turn;
// all 16 rows of the m16n8k16 m-tile carry query heads (rows past G zero),
// so a group of up to 16 heads is one launch, and a thread holds only the
// upper 8 rows where G <= 8 (half the accumulators). The warps merge in
// shared memory; then each CTA sends rank r of the cluster only rank r's
// share of the G x DH outputs and every row's (m, l) (a reduce-scatter
// through distributed shared memory), and after one cluster barrier each
// rank merges its share in rank order, normalises and stores it.
//
// float32 q, and bf16 at dh 32 and 256: decode_cluster, the first
// design. A cluster of up to 8 CTAs per (batch, kv head) row; each CTA
// takes a contiguous chunk of slots and each of its warps tiles of 32
// slots. A warp copies a tile's K and V rows (and, for K3, the tile's 32 k
// and 32 v scales, each lane its own slot's) into its own shared-memory
// ring with cp.async (two stages when it has more than one tile, so that
// the next tile is in flight) before q is read, and rescales its online
// softmax once per tile. The warps' (m, l, acc) merge in the CTA; each CTA
// writes its merged partial into the shared memory of every CTA of the
// cluster (distributed shared memory), and after one cluster barrier each
// rank merges the ranks' partials of an n_ranks-th of the outputs,
// normalises and writes them. A group of more than 8 query heads per kv
// head runs as several launches, each over an equal sub-group of at most
// 8 heads, reading q and writing o in place (decode_sm90: of at most 16).
//
// decode_cluster's passes. K2, bf16 (MmaPass): the tile on the tensor
// cores. The G query rows are
// the rows of a 16-row mma.sync m16n8k16 tile, S = Q K^T and P.V take
// their operands from shared memory by ldmatrix, scores and p stay in
// registers; p is rounded to bf16 for P.V and the f32 p summed into l.
//
// K3, bf16 (Q8MmaPass): the same tile pass over int8 rows, on the tensor
// cores, with no dequantised copy of the tile. An int8 value is exact in
// bf16 (|x| <= 127 needs 7 significant bits of bf16's 8) and a bf16 q is
// exact, so S = Q K8^T accumulated in f32 equals the f32-dequantised dot
// up to summation order; each score column is then multiplied by its
// slot's k scale and dh^-0.5 in f32, before masking and the online
// softmax. For P.V, p times the slot's v scale is rounded to bf16 against
// V8 in bf16, and l sums the unrounded f32 p: K2's rounding of p, and the
// reference model's own kv_quant arithmetic, which dequantises the cache
// to the compute type and rounds p to it (src/repro/models/
// transformer.py, decode; ref.py::decode_attention_q8_ref). Fragments are
// built from int8 in registers: a byte becomes a float by a byte permute
// onto 2^23 and one subtraction, and two such floats a bf16x2 by taking
// their high halves. S = Q K8^T runs the k dimension of each 16-wide
// k-step in an order of its own, the same for q and k (the dot does not
// depend on it): lane t's two B registers are bytes 4t..4t+3 of the slot's
// row, one 32-bit load. For P.V each B register holds two slots at one
// d; a lane loads 4 bytes of each of its 4 slot rows (32-bit loads) and
// takes byte j of them for the j-th of 4 output n-tiles, so column n of
// n-tile 4 blk + j is output column 32 blk + 4 n + j (converting the V
// tile into a bf16 copy read by ldmatrix, as K2 reads its own, measured
// slower: scripts/attention_variants.py). The
// query rows are the upper half of the m16n8k16 tile only (G <= 8): the
// lower half of A is zero and its accumulators are dropped. Rows are
// padded by 16 bytes, which keeps every one of these loads free of bank
// conflicts at each head dim.
//
// f32 (SimtPass), K2 and K3: on the CUDA cores (TF32 would not hold the
// f32 tolerance). A lane owns a slot's dot products with the G query
// rows, p goes through shared memory to P.V, where a lane owns dh/32
// output columns. K2 keeps p as it is (the cache type is f32); K3
// converts int8 to f32 in registers, multiplies the scores by the k
// scale, and keeps p times the v scale in f32.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>
#include <type_traits>

#include "sm90_helpers.cuh"
#include "sm90_tma.cuh"

namespace {

using namespace repro_sm90;

namespace cg = cooperative_groups;

constexpr float NEG_INF = -1e30f;
constexpr int MAX_DEVICES = 64;

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

// 4 bytes global -> shared (cp.async takes 4 bytes only as .ca); with ok
// false nothing is read and the 4 bytes are zero-filled.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

using bf16 = __nv_bfloat16;

constexpr int TS = 32;            // cache slots per tile: one per lane
constexpr int MAX_CLUSTER = 8;    // CTAs per cluster, the portable limit
constexpr int MAX_GROUP = 8;      // query heads per kv head
constexpr size_t SMEM_LIMIT = 232448;  // dynamic shared memory per CTA
constexpr float LOG2E = 1.4426950408889634f;

// The kernel's shape per q/output type T, cache element type C (T for K2,
// int8 for K3) and head dim: bf16 q runs the tile pass on the tensor cores
// (MMA), f32 on the CUDA cores with GM = 8 query rows in registers (rows
// past G zero; f32 is off the serving path, so one instance serves every
// G <= 8); warps per CTA (two where a tile of 32 f32 rows of dh 256 would
// not fit four times over). K2's bf16 tiles keep ldmatrix's eight rows in
// distinct bank groups: rows of dh >= 128 are unpadded with their 16-byte
// chunks swizzled (chunk c of row r at c ^ (r & 7)), so that 3 CTAs fit
// on an SM at qwen3-1.7b's shapes; other rows, and every int8 row, are
// padded by 16 bytes (at dh 64 that measured faster for K2). A K3 stage
// ends with its tile's 32 k scales and 32 v scales. Shared memory, from
// its start: q (K2 bf16: G rows at stride RB and a zero row; K3 bf16: G
// rows of dh; f32: GM rows), the p of each warp's tile (f32 only), the
// cluster's gather slots (every rank's G partials), then each warp's ring
// of n_stages tiles.
template <typename T, typename C, int DH>
struct Shape {
  static constexpr bool Q8 = std::is_same<C, int8_t>::value;
  static constexpr bool MMA = std::is_same<T, bf16>::value;
  static constexpr int GM = MAX_GROUP;
  static constexpr int NW = DH * sizeof(C) >= 1024 ? 2 : 4;
  static constexpr bool SWZ = MMA && !Q8 && DH >= 128;
  static constexpr int RB = DH * (int)sizeof(C) + (SWZ ? 0 : 16);
  static constexpr int STAGE =
      2 * TS * RB + (Q8 ? 2 * TS * (int)sizeof(float) : 0);
  static constexpr int PS = DH + 2;  // a partial: acc, m, l
  static constexpr int QRB = MMA ? (Q8 ? DH * 2 : RB) : DH * 4;
  __host__ __device__ static constexpr int q_rows(int G) {
    return MMA ? (Q8 ? G : G + 1) : GM;
  }
  __host__ __device__ static constexpr size_t q_bytes(int G) {
    return (size_t)q_rows(G) * QRB;
  }
  __host__ __device__ static constexpr size_t p_bytes() {
    return MMA ? 0 : sizeof(float) * NW * GM * TS;
  }
  __host__ __device__ static constexpr size_t head(int G) {
    return (q_bytes(G) + p_bytes() +
            sizeof(float) * MAX_CLUSTER * G * PS + 15) / 16 * 16;
  }
};

// N values of T (f32, bf16 or int8) from shared memory at p (aligned to
// their size, up to 16 bytes), as floats
template <typename T, int N>
__device__ __forceinline__ void load_f(const unsigned char* p,
                                       float (&out)[N]) {
  constexpr int BYTES = N * (int)sizeof(T);
  uint32_t w[(BYTES + 3) / 4];
  if constexpr (BYTES >= 16) {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = u.x;
      w[4 * i + 1] = u.y;
      w[4 * i + 2] = u.z;
      w[4 * i + 3] = u.w;
    }
  } else if constexpr (BYTES == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x;
    w[1] = u.y;
  } else if constexpr (BYTES == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (BYTES == 2) {
    w[0] = *reinterpret_cast<const unsigned short*>(p);
  } else {
    w[0] = *p;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (sizeof(T) == 4)
      out[i] = __uint_as_float(w[i]);
    else if constexpr (sizeof(T) == 2)  // element 2j: the low half of word j
      out[i] = __uint_as_float((i & 1) ? (w[i / 2] & 0xffff0000u)
                                       : (w[i / 2] << 16));
    else  // int8: byte i % 4 of word i / 4, sign-extended
      out[i] = (float)((int)(w[i / 4] << (24 - 8 * (i % 4))) >> 24);
  }
}

// Where chunk c of row r of a bf16 tile of CPR chunks a row lies
template <int CPR>
__device__ __forceinline__ int swz(int r, int c) {
  return c ^ (r & (CPR >= 8 ? 7 : CPR - 1));
}

// A warp's pass over its tiles on the tensor cores (K2, bf16). The G query
// rows are the first rows of a 16-row m-tile (the rest zero); the 32
// slots of a tile are four 8-slot n-tiles, so S = Q K^T is KD x 4 mmas and
// P.V 2 x DH/8. Each thread holds rows g and g + 8 of every fragment. Q's
// fragments stay in registers up to dh 128; at dh 256, beside a 128-
// register accumulator, they are re-read from shared memory.
template <int DH, int RB, bool SWZ>
struct MmaPass {
  static constexpr int KD = DH / 16, ND = DH / 8, CPR = DH / 8, PS = DH + 2;
  static constexpr bool Q_IN_REGS = DH <= 128;

  // the byte offset of chunk c of row r of a tile
  __device__ __forceinline__ static int at(int r, int c) {
    return r * RB + (SWZ ? swz<CPR>(r, c) : c) * 16;
  }
  uint32_t qf[Q_IN_REGS ? KD : 1][4];
  uint32_t qa;  // this lane's ldmatrix address of Q's first k-step
  float acc[ND][4];
  float m[2], l[2];  // running max (log2 units), this thread's row sums

  // q rows 0..G-1 of shared memory, row G zero: m-tile rows past G read
  // the zero row
  __device__ __forceinline__ void init(const unsigned char* qsm, int G,
                                       int lane) {
    const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int a_col = (lane >> 4) * 8;
    qa = smem_u32(qsm + (a_row < G ? a_row : G) * RB + a_col * 2);
    if constexpr (Q_IN_REGS) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) ldsm_x4(qf[kk], qa + kk * 32);
    }
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    m[0] = m[1] = NEG_INF;
    l[0] = l[1] = 0.f;
  }

  // mask: bit i set iff slot i of the tile is valid
  __device__ __forceinline__ void tile(const unsigned char* kt,
                                       const unsigned char* vt, unsigned mask,
                                       float scale_log2, const unsigned char*,
                                       float*, int lane) {
    const int t = lane % 4;
    const int k_row = (lane & 7) + (lane >> 4) * 8;
    const int k_col = ((lane >> 3) & 1) * 8;
    const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int v_col = (lane >> 4) * 8;
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      if constexpr (Q_IN_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldsm_x4(a, qa + kk * 32);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bb[4];
        ldsm_x4(bb, smem_u32(kt + at(np * 16 + k_row, 2 * kk + k_col / 8)));
        mma_bf16(s[2 * np], a, bb[0], bb[1]);
        mma_bf16(s[2 * np + 1], a, bb[2], bb[3]);
      }
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = (mask >> (8 * j + 2 * t + (e & 1))) & 1u;
        s[j][e] = ok ? s[j][e] * scale_log2 : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      const float alpha = ex2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        acc[j][2 * r] *= alpha;
        acc[j][2 * r + 1] *= alpha;
      }
    }
    // p in f32 into l (0 for an invalid slot); rounded to bf16 into the A
    // fragments of P.V
    uint32_t pa[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = (mask >> (8 * j + 2 * t + (e & 1))) & 1u;
        p[e] = ok ? ex2(s[j][e] - m[e >> 1]) : 0.f;
      }
      l[0] += p[0] + p[1];
      l[1] += p[2] + p[3];
      pa[j / 2][(j & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t bb[4];
        ldsm_x4_t(bb, smem_u32(vt + at(kk * 16 + v_row, 2 * dp + v_col / 8)));
        mma_bf16(acc[2 * dp], pa[kk], bb[0], bb[1]);
        mma_bf16(acc[2 * dp + 1], pa[kk], bb[2], bb[3]);
      }
  }

  // the warp's (acc, m, l) of query rows below G into wp (G x PS)
  __device__ __forceinline__ void flush(float* wp, int G, int lane) {
    const int g = lane / 4, t = lane % 4;
    float lr = l[0];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    if (g >= G) return;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      wp[g * PS + 8 * j + 2 * t] = acc[j][0];
      wp[g * PS + 8 * j + 2 * t + 1] = acc[j][1];
    }
    if (t == 0) {
      wp[g * PS + DH] = m[0];
      wp[g * PS + DH + 1] = lr;
    }
  }
};

// int8 -> bf16 fragments. A word of 4 int8 values XOR 0x80808080 holds
// each x as x + 128 unsigned; byte i of it permuted under 2^23 gives the
// float 2^23 + x + 128, and one subtraction x exactly.
constexpr uint32_t I8_BIAS = 0x80808080u;
constexpr uint32_t F32_2P23 = 0x4b000000u;  // 2^23
constexpr float I8_MAGIC = 8388736.f;       // 2^23 + 128

// byte i (0-3) of a biased int8 word, as a float
__device__ __forceinline__ float i8_at(uint32_t biased, int i) {
  return __uint_as_float(__byte_perm(biased, F32_2P23, 0x7650 + i)) -
         I8_MAGIC;
}

// two floats of at most 8 significant bits (int8 values) as bf16x2, lo in
// the low half: their high halves, exactly
__device__ __forceinline__ uint32_t bf16x2_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// c (rows g of an m16n8 f32 tile: columns 2t, 2t + 1) += A B with A's rows
// g + 8 zero: a0 = A[g][2t, 2t + 1], a2 = A[g][2t + 8, 2t + 9]. The
// m16n8k16 bf16 mma, the accumulators of the zero rows dropped.
__device__ __forceinline__ void mma_bf16_upper(float (&c)[2], uint32_t a0,
                                               uint32_t a2, uint32_t b0,
                                               uint32_t b1) {
  float d2, d3;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%10,%11};\n"
      : "+f"(c[0]), "+f"(c[1]), "=f"(d2), "=f"(d3)
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1), "f"(0.f),
        "f"(0.f));
}

// A warp's pass over its int8 tiles on the tensor cores (K3, bf16 q). The
// G query rows are rows g < G of the upper half of a 16-row m-tile; a
// thread holds one query row (g = lane / 4) and, of each 8-slot n-tile,
// slots 2t and 2t + 1 (t = lane % 4). S = Q K8^T is KD x 4 mmas: in k-step
// kk, q's A registers are q[g][16kk + 4t .. 16kk + 4t + 3] (one 64-bit
// load, once) and k's B registers bytes 16kk + 4t .. + 3 of slot row
// 8j + g (one 32-bit load). P.V is 2 x DH/8 mmas: in k-step kk (slots
// 16kk .. 16kk + 15) and 32-wide block blk, a thread loads bytes
// 32blk + 4g .. + 3 of slot rows 16kk + 2t, + 1, + 8 and + 9, and byte j of
// them is B of n-tile 4blk + j; so accumulator (j, e) of block blk is
// output column 32blk + 8t + 4e + j.
template <int DH, int RB>
struct Q8MmaPass {
  static constexpr int KD = DH / 16, ND = DH / 8, PS = DH + 2;
  uint32_t qf[KD][2];
  float acc[ND][2];
  float m, l;  // running max (log2 units), this thread's row sum

  // q rows 0..G-1 of shared memory (bf16, DH a row); rows past G zero
  __device__ __forceinline__ void init(const unsigned char* qsm, int G,
                                       int lane) {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint2 w = make_uint2(0u, 0u);
      if (g < G)
        w = *reinterpret_cast<const uint2*>(qsm +
                                            (g * DH + 16 * kk + 4 * t) * 2);
      qf[kk][0] = w.x;
      qf[kk][1] = w.y;
    }
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = 0.f;
    m = NEG_INF;
    l = 0.f;
  }

  // mask: bit i set iff slot i of the tile is valid; the tile's k scales
  // and v scales follow its V rows
  __device__ __forceinline__ void tile(const unsigned char* kt,
                                       const unsigned char* vt, unsigned mask,
                                       float scale_log2, const unsigned char*,
                                       float*, int lane) {
    const int g = lane / 4, t = lane % 4;
    const float* sc = reinterpret_cast<const float*>(vt + TS * RB);
    float s[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(
                               kt + (8 * j + g) * RB + 16 * kk + 4 * t) ^
                           I8_BIAS;
        mma_bf16_upper(s[j], qf[kk][0], qf[kk][1],
                       bf16x2_exact(i8_at(w, 0), i8_at(w, 1)),
                       bf16x2_exact(i8_at(w, 2), i8_at(w, 3)));
      }
    // score (j, e) is slot 8j + 2t + e: its k scale, then the mask
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 ks = *reinterpret_cast<const float2*>(sc + 8 * j + 2 * t);
      const unsigned ok = mask >> (8 * j + 2 * t);
      s[j][0] = (ok & 1u) ? s[j][0] * (ks.x * scale_log2) : NEG_INF;
      s[j][1] = (ok & 2u) ? s[j][1] * (ks.y * scale_log2) : NEG_INF;
      mx = fmaxf(mx, fmaxf(s[j][0], s[j][1]));
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = ex2(m - m_new);
    m = m_new;
    l *= alpha;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[j][0] *= alpha;
      acc[j][1] *= alpha;
    }
    // p in f32 into l (0 for an invalid slot); p times the slot's v scale
    // rounded to bf16 into P.V's A registers: k-step kk's a0 is n-tile
    // 2kk, its a2 n-tile 2kk + 1
    uint32_t pa[2][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 vs =
          *reinterpret_cast<const float2*>(sc + TS + 8 * j + 2 * t);
      const unsigned ok = mask >> (8 * j + 2 * t);
      const float p0 = (ok & 1u) ? ex2(s[j][0] - m) : 0.f;
      const float p1 = (ok & 2u) ? ex2(s[j][1] - m) : 0.f;
      l += p0 + p1;
      pa[j / 2][j & 1] = pack_bf16(p0 * vs.x, p1 * vs.y);
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const unsigned char* r0 = vt + (16 * kk + 2 * t) * RB + 4 * g;
#pragma unroll
      for (int blk = 0; blk < DH / 32; ++blk) {
        const unsigned char* p = r0 + 32 * blk;
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(p) ^ I8_BIAS;
        const uint32_t w1 =
            *reinterpret_cast<const uint32_t*>(p + RB) ^ I8_BIAS;
        const uint32_t w8 =
            *reinterpret_cast<const uint32_t*>(p + 8 * RB) ^ I8_BIAS;
        const uint32_t w9 =
            *reinterpret_cast<const uint32_t*>(p + 9 * RB) ^ I8_BIAS;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16_upper(acc[4 * blk + j], pa[kk][0], pa[kk][1],
                         bf16x2_exact(i8_at(w0, j), i8_at(w1, j)),
                         bf16x2_exact(i8_at(w8, j), i8_at(w9, j)));
      }
    }
  }

  // the warp's (acc, m, l) of query rows below G into wp (G x PS)
  __device__ __forceinline__ void flush(float* wp, int G, int lane) {
    const int g = lane / 4, t = lane % 4;
    float lr = l;
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    if (g >= G) return;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = 32 * (j / 4) + 8 * t + (j % 4);
      wp[g * PS + d] = acc[j][0];
      wp[g * PS + d + 4] = acc[j][1];
    }
    if (t == 0) {
      wp[g * PS + DH] = m;
      wp[g * PS + DH + 1] = lr;
    }
  }
};

// A warp's pass over its tiles on the CUDA cores (f32 q; C is the cache's
// element type, f32 for K2, int8 for K3). A lane owns one slot for the
// scores (its K row against the GM query rows, read as broadcasts from
// shared memory, four partial sums per row) and DH/32 output columns for
// P.V; one online-softmax rescale per tile. K3's int8 values become floats
// in registers; a lane's score takes its slot's k scale, and p its slot's
// v scale, in f32.
template <typename C, int DH, int GM>
struct SimtPass {
  static constexpr bool Q8 = std::is_same<C, int8_t>::value;
  static constexpr int EPC = 16 / (int)sizeof(C);  // elements per 16 bytes
  static constexpr int CPR = DH / EPC;             // 16-byte chunks per row
  static constexpr int RB = DH * (int)sizeof(C) + 16;
  static constexpr int E = DH / 32;                // output columns per lane
  static constexpr int PS = DH + 2;
  float m[GM], lsum[GM], acc[GM][E];

  __device__ __forceinline__ void init(const unsigned char*, int, int) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      m[g] = NEG_INF;
      lsum[g] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
    }
  }

  __device__ __forceinline__ void tile(const unsigned char* kt,
                                       const unsigned char* vt, unsigned mask,
                                       float scale_log2,
                                       const unsigned char* qsm, float* pw,
                                       int lane) {
    const float* qs = reinterpret_cast<const float*>(qsm);
    const float* sc = reinterpret_cast<const float*>(vt + TS * RB);  // K3
    const bool ok = (mask >> lane) & 1u;
    float s[GM][4];
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int u = 0; u < 4; ++u) s[g][u] = 0.f;
#pragma unroll 4
    for (int c = 0; c < CPR; ++c) {
      float kf[EPC];
      load_f<C, EPC>(kt + lane * RB + c * 16, kf);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float4* qv =
            reinterpret_cast<const float4*>(qs + g * DH + c * EPC);
#pragma unroll
        for (int e4 = 0; e4 < EPC / 4; ++e4) {
          const float4 qq = qv[e4];
          s[g][0] = fmaf(qq.x, kf[4 * e4], s[g][0]);
          s[g][1] = fmaf(qq.y, kf[4 * e4 + 1], s[g][1]);
          s[g][2] = fmaf(qq.z, kf[4 * e4 + 2], s[g][2]);
          s[g][3] = fmaf(qq.w, kf[4 * e4 + 3], s[g][3]);
        }
      }
    }
    float ksl = scale_log2, vsc = 1.f;
    if constexpr (Q8) {
      ksl *= sc[lane];
      vsc = sc[TS + lane];
    }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float dot = (s[g][0] + s[g][1]) + (s[g][2] + s[g][3]);
      const float x = ok ? dot * ksl : NEG_INF;
      float mt = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[g], mt);
      const float alpha = exp2f(m[g] - m_new);
      m[g] = m_new;
      const float p = ok ? exp2f(x - m_new) : 0.f;
      lsum[g] = lsum[g] * alpha + p;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
      pw[g * TS + lane] = Q8 ? p * vsc : p;  // K2: p in the (f32) cache type
    }
    __syncwarp();
    const unsigned char* vcol = vt + lane * E * (int)sizeof(C);
#pragma unroll 2
    for (int j4 = 0; j4 < TS / 4; ++j4) {
      float pp[GM][4];
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float4 p4 = reinterpret_cast<const float4*>(pw + g * TS)[j4];
        pp[g][0] = p4.x;
        pp[g][1] = p4.y;
        pp[g][2] = p4.z;
        pp[g][3] = p4.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vf[E];
        load_f<C, E>(vcol + (4 * j4 + jj) * RB, vf);
#pragma unroll
        for (int g = 0; g < GM; ++g)
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[g][e] = fmaf(pp[g][jj], vf[e], acc[g][e]);
      }
    }
  }

  __device__ __forceinline__ void flush(float* wp, int G, int lane) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float L = warp_sum(lsum[g]);
      if (g >= G) continue;
#pragma unroll
      for (int e = 0; e < E; ++e) wp[g * PS + lane * E + e] = acc[g][e];
      if (lane == 0) {
        wp[g * PS + DH] = m[g];
        wp[g * PS + DH + 1] = L;
      }
    }
  }
};

// One cluster of gridDim.x CTAs per batch*kv-head row (blockIdx.y); CTA
// rank r takes slots [r * chunk, (r + 1) * chunk). n_stages: 2 if a warp
// has more than one tile and two fit, else 1. k_scale / v_scale: K3's
// (B, S, KV) scales, unread by K2.
template <typename T, typename C, int DH>
__global__ void __launch_bounds__(Shape<T, C, DH>::NW * 32)
    decode_cluster(const T* __restrict__ q, const C* __restrict__ k,
                   const float* __restrict__ k_scale,
                   const C* __restrict__ v,
                   const float* __restrict__ v_scale, T* __restrict__ o,
                   int S, int H, int KV, int qg, int q0, int pos, int window,
                   int ring, int chunk, int n_stages, float scale_log2) {
  using SH = Shape<T, C, DH>;
  constexpr int NW_ = SH::NW, NTH = NW_ * 32, RB = SH::RB, PS = SH::PS;
  constexpr int GM = SH::GM;
  constexpr int CEPC = 16 / (int)sizeof(C);  // cache elements per 16 bytes
  constexpr int CCPR = DH / CEPC;            // 16-byte chunks of a cache row
  constexpr int QEPC = 16 / (int)sizeof(T);  // q elements per 16 bytes
  constexpr int QCPR = DH / QEPC;            // 16-byte chunks of a q row
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / KV;
  unsigned char* qsm = smem;
  float* ps = reinterpret_cast<float*>(smem + SH::q_bytes(G));
  float* gather =
      reinterpret_cast<float*>(smem + SH::q_bytes(G) + SH::p_bytes());
  unsigned char* ring_tiles = smem + SH::head(G);

  // every CTA of the cluster has started before any writes into another's
  // shared memory: arrive now, wait before the first remote write
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_ranks = (int)cluster.num_blocks();
  const int bkv = blockIdx.y, b = bkv / KV, kvh = bkv % KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const int s0 = rank * chunk, s1 = min(S, s0 + chunk);
  const int n_tiles = s1 > s0 ? (s1 - s0 + TS - 1) / TS : 0;
  const int my_tiles = n_tiles > warp ? (n_tiles - warp + NW_ - 1) / NW_ : 0;
  unsigned char* wring = ring_tiles + (size_t)warp * n_stages * SH::STAGE;
  const size_t slot_stride = (size_t)KV * DH;
  const size_t row0 = (size_t)b * S * KV + kvh;  // slot 0's (b, kvh) row
  const C* krow0 = k + row0 * DH;
  const C* vrow0 = v + row0 * DH;

  // the first slot of this warp's i-th tile; whether slot s is valid
  auto tile_slot = [&](int i) { return s0 + (warp + i * NW_) * TS; };
  auto valid = [&](int s) {
    if (s >= s1) return false;
    const int sp = slot_position(s, S, pos, ring != 0);
    return sp >= 0 && sp <= pos && !(window > 0 && sp <= pos - window);
  };
  auto fetch = [&](int i, int stage) {
    const int first = tile_slot(i);
    const unsigned mask = __ballot_sync(0xffffffffu, valid(first + lane));
    if (mask == 0) return;  // no valid slot: nothing read
    unsigned char* kt = wring + stage * SH::STAGE;
    unsigned char* vt = kt + TS * RB;
    for (int c = lane; c < TS * CCPR; c += 32) {
      const int r = c / CCPR, cc = c % CCPR;
      const bool ok = (mask >> r) & 1u;
      const size_t off = (size_t)(ok ? first + r : 0) * slot_stride + cc * CEPC;
      const int pc = SH::SWZ ? swz<CCPR>(r, cc) : cc;
      cp_async16(smem_u32(kt + r * RB + pc * 16), krow0 + off, ok);
      cp_async16(smem_u32(vt + r * RB + pc * 16), vrow0 + off, ok);
    }
    if constexpr (SH::Q8) {  // each lane its own slot's two scales
      float* sc = reinterpret_cast<float*>(vt + TS * RB);
      const bool ok = (mask >> lane) & 1u;
      const size_t off = row0 + (size_t)(ok ? first + lane : 0) * KV;
      cp_async4(smem_u32(sc + lane), k_scale + off, ok);
      cp_async4(smem_u32(sc + TS + lane), v_scale + off, ok);
    }
  };

  // q, then the cache's first tiles, go in flight at once: q in group 0
  // (zero rows past G zero-filled without a read)
  {
    const int q_rows = SH::q_rows(G);
    const T* qrow0 = q + ((size_t)bkv * qg + q0) * DH;
    // one or two rounds; unrolled, it made K2's bf16 dh-32 instance spill
#pragma unroll 1
    for (int i = threadIdx.x; i < q_rows * QCPR; i += NTH) {
      const int r = i / QCPR, c = i % QCPR;
      cp_async16(smem_u32(qsm + r * SH::QRB + c * 16),
                 qrow0 + (r < G ? r * DH + c * QEPC : 0), r < G);
    }
    cp_async_commit();
  }
  for (int j = 0; j < n_stages; ++j) {
    if (j < my_tiles) fetch(j, j);
    cp_async_commit();
  }
  if (n_stages == 2)
    cp_async_wait<2>();  // q has landed
  else
    cp_async_wait<1>();
  __syncthreads();

  std::conditional_t<SH::MMA,
                     std::conditional_t<SH::Q8, Q8MmaPass<DH, RB>,
                                        MmaPass<DH, RB, SH::SWZ>>,
                     SimtPass<C, DH, GM>>
      pass;
  pass.init(qsm, G, lane);
  float* pw = ps + warp * GM * TS;
  for (int i = 0; i < my_tiles; ++i) {
    const int stage = n_stages == 1 ? 0 : (i & 1);
    if (n_stages == 2)
      cp_async_wait<1>();  // tile i has landed, tile i + 1 may not have
    else
      cp_async_wait<0>();
    __syncwarp();
    const unsigned mask =
        __ballot_sync(0xffffffffu, valid(tile_slot(i) + lane));
    if (mask != 0) {
      const unsigned char* kt = wring + stage * SH::STAGE;
      pass.tile(kt, kt + TS * RB, mask, scale_log2, qsm, pw, lane);
    }
    __syncwarp();  // the warp is done with this stage (and pw)
    if (i + n_stages < my_tiles) fetch(i + n_stages, stage);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncwarp();

  // the warp's partial into its own ring, then the CTA's partial into
  // gather slot `rank` of every rank of the cluster
  pass.flush(reinterpret_cast<float*>(wring), G, lane);
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int i = threadIdx.x; i < G * DH; i += NTH) {
    const int g = i / DH, d = i % DH;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW_; ++w)
      M = fmaxf(M, reinterpret_cast<const float*>(
                       ring_tiles + (size_t)w * n_stages * SH::STAGE)[g * PS + DH]);
    float a = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < NW_; ++w) {
      const float* src = reinterpret_cast<const float*>(
                             ring_tiles + (size_t)w * n_stages * SH::STAGE) +
                         g * PS;
      const float sc = exp2f(src[DH] - M);
      a += src[d] * sc;
      L += src[DH + 1] * sc;
    }
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r) {
      if (r < n_ranks) {
        float* dst =
            cluster.map_shared_rank(gather, r) + (size_t)(rank * G + g) * PS;
        dst[d] = a;
        if (d == 0) {
          dst[DH] = M;
          dst[DH + 1] = L;
        }
      }
    }
  }

  // each rank merges the ranks' partials of its share of the G x DH
  // outputs from its own shared memory, normalises and writes them
  cluster.sync();
  const int per = (G * DH + n_ranks - 1) / n_ranks;
  const int i_end = min(G * DH, (rank + 1) * per);
  for (int i = rank * per + threadIdx.x; i < i_end; i += NTH) {
    const int g = i / DH, d = i % DH;
    float M = NEG_INF;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < n_ranks) M = fmaxf(M, gather[(r * G + g) * PS + DH]);
    float a = 0.f, L = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r) {
      if (r < n_ranks) {
        const float* src = gather + (r * G + g) * PS;
        const float sc = exp2f(src[DH] - M);
        a += src[d] * sc;
        L += src[DH + 1] * sc;
      }
    }
    o[((size_t)bkv * qg + q0 + g) * DH + d] =
        from_f<T>(a / fmaxf(L, 1e-30f));
  }
}

template <typename T, typename C, int DH>
cudaError_t launch(const void* q, const void* k, const void* ks,
                   const void* v, const void* vs, void* o, int B, int S,
                   int H, int KV, int qg, int q0, int pos, int window,
                   int ring, int n_ctas, int chunk, float scale,
                   cudaStream_t stream) {
  using SH = Shape<T, C, DH>;
  if (n_ctas < 1 || n_ctas > MAX_CLUSTER || chunk < 1 ||
      (long)n_ctas * chunk < S)
    return cudaErrorInvalidValue;
  const int tiles = (chunk + TS - 1) / TS;
  const auto smem_for = [G = H / KV](int stages) {
    return SH::head(G) + (size_t)SH::NW * stages * SH::STAGE;
  };
  const int n_stages = tiles > SH::NW && smem_for(2) <= SMEM_LIMIT ? 2 : 1;
  cudaError_t err = allow_optin_smem<decode_cluster<T, C, DH>>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_ctas, B * KV);
  cfg.blockDim = dim3(SH::NW * 32);
  cfg.dynamicSmemBytes = smem_for(n_stages);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, decode_cluster<T, C, DH>, static_cast<const T*>(q),
      static_cast<const C*>(k), static_cast<const float*>(ks),
      static_cast<const C*>(v), static_cast<const float*>(vs),
      static_cast<T*>(o), S, H, KV, qg, q0, pos, window, ring, chunk,
      n_stages, scale * LOG2E);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, typename C>
cudaError_t launch_dh(int dh, const void* q, const void* k, const void* ks,
                      const void* v, const void* vs, void* o, int B, int S,
                      int H, int KV, int qg, int q0, int pos, int window,
                      int ring, int n_ctas, int chunk, float scale,
                      cudaStream_t stream) {
  if (KV < 1 || H % KV || H / KV > MAX_GROUP || q0 < 0 ||
      q0 + H / KV > qg)
    return cudaErrorInvalidValue;
#define DECODE_CASE(D)                                                       \
  case D:                                                                    \
    return launch<T, C, D>(q, k, ks, v, vs, o, B, S, H, KV, qg, q0, pos,     \
                           window, ring, n_ctas, chunk, scale, stream);
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

// --- the Hopper kernel: decode_sm90 (bf16 q at dh 64 and 128) ---------------

constexpr int SM90_WARPS = 4;                        // consumer warps
constexpr int SM90_THREADS = 32 * (SM90_WARPS + 1);  // + the producer warp
constexpr int SM90_MAX_CLUSTER = 16;  // CTAs per cluster (non-portable)
constexpr int SM90_MAX_GROUP = 16;    // query heads per kv head: the m-tile
constexpr int SM90_BAR = 1;           // the consumers' named barrier

// The shape of decode_sm90 per cache element type C (bf16: K2, int8: K3)
// and head dim. A cache row of one kv head is ROW bytes; TMA loads it in
// boxes of BOX_W bytes (the 128-byte swizzle takes at most 128 bytes a
// box row, so a bf16 row at dh 128 is two boxes; an int8 row at dh 64 is
// one box under the 64-byte swizzle). A stage of the ring holds one
// 32-slot tile of K, then of V. The ring is at most 64 KB deep (4 stages
// of a bf16 dh-128 tile, 8 of the others), so that the card holds far
// more than its latency x bandwidth product (~3 MB) in flight.
template <typename C, int DH>
struct Sm90Shape {
  static constexpr bool Q8 = std::is_same<C, int8_t>::value;
  static constexpr int ROW = DH * (int)sizeof(C);
  static constexpr int BOX_W = ROW > 128 ? 128 : ROW;
  static constexpr int BOX = TS * BOX_W;
  static constexpr int TILE = TS * ROW;
  static constexpr int STAGE = 2 * TILE;
  static constexpr int MAX_STAGES = 65536 / STAGE;
  // q's 16 rows in shared memory: K2 in the tiles' swizzled layout (for
  // ldmatrix), K3 row-major with rows 32 bytes longer than q's (its 64-bit
  // loads free of bank conflicts)
  static constexpr int QROW = Q8 ? DH * 2 + 32 : DH * 2;
  static constexpr int Q_BYTES = SM90_MAX_GROUP * QROW;
};

// Byte offsets in shared memory from its 1024-byte aligned start: the
// ring (after the pass the warps' rescaled partials, SM90_WARPS x G x DH
// floats, take its place), q, the barriers (full, then empty, one a
// stage), the tiles' scales (K3: 32 k then 32 v scales a stage), each
// warp's (m, l) of each row, and the cluster's gather slots: the share of
// the G x DH outputs this rank merges, from every rank, then every rank's
// (M, L) of each row. share: floats of a rank's share, a multiple of 4.
struct Sm90Layout {
  uint32_t q, bars, scales, ml, gather, gather_ml, total;
  int share;
};

template <typename C, int DH>
__host__ __device__ inline Sm90Layout sm90_layout(int G, int n, int stages) {
  using SH = Sm90Shape<C, DH>;
  Sm90Layout L;
  const uint32_t ring = (uint32_t)stages * SH::STAGE;
  const uint32_t part = (uint32_t)SM90_WARPS * G * DH * 4;
  L.q = ((ring > part ? ring : part) + 127) / 128 * 128;
  L.bars = L.q + SH::Q_BYTES;
  L.scales = L.bars + 16 * stages;
  L.ml = L.scales + (SH::Q8 ? stages * 2 * TS * 4 : 0);
  L.share = ((G * DH + n - 1) / n + 3) / 4 * 4;
  L.gather = (L.ml + SM90_WARPS * G * 8 + 15) / 16 * 16;
  L.gather_ml = L.gather + n * L.share * 4;
  L.total = L.gather_ml + n * G * 8;
  return L;
}

// The byte offset of 16-byte chunk c of row r of a tile (ROWS = 32 slots)
// or of q (16 rows) as TMA's swizzle lays out boxes of BOX_W-byte rows:
// the box (c / (BOX_W / 16)), the row, then the chunk XOR the row's
// swizzle bits (128-byte swizzle: r mod 8; 64-byte: (r / 2) mod 4), which
// puts the 8 rows an ldmatrix or a quarter-warp load reads in distinct
// bank groups.
template <int BOX_W, int ROWS>
__device__ __forceinline__ int sw_at(int r, int c) {
  constexpr int CPB = BOX_W / 16;
  const int x = BOX_W == 128 ? (r & 7) : ((r >> 1) & 3);
  return (c / CPB) * (ROWS * BOX_W) + r * BOX_W + ((c % CPB) ^ x) * 16;
}

__device__ __forceinline__ uint32_t lds32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}

// c += A B on one m16n8k16 bf16 mma: the 16-row tile (R = 2: c holds rows
// g and g + 8) or its upper half (R = 1: rows 8-15 of A zero and their
// accumulators dropped, half the registers; a[1] and a[3] unread)
template <int R>
__device__ __forceinline__ void mma_rows(float (&c)[2 * R],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  if constexpr (R == 2)
    mma_bf16(c, a, b0, b1);
  else
    mma_bf16_upper(c, a[0], a[2], b0, b1);
}

// The online softmax of a tile's scores s (s[j][e]: slot 8j + 2t + (e & 1)
// of row g + 8 (e >> 1), e < 2R), already scaled to log2 units: masked
// slots to -1e30, the running max, the rescale of l and acc, then p in
// f32 into l (0 for an invalid slot) and, times vs(j, e & 1) (1 for K2,
// the slot's v scale for K3), rounded to bf16 into the A fragments of
// P.V (pa[kk][1] and pa[kk][3], rows g + 8, only where R = 2).
template <int R, int ND, typename VS>
__device__ __forceinline__ void online_softmax(float (&s)[4][2 * R],
                                               float (&acc)[ND][2 * R],
                                               float (&m)[R], float (&l)[R],
                                               uint32_t (&pa)[2][4],
                                               unsigned mask, int t, VS vs) {
  float mx[R];
#pragma unroll
  for (int r = 0; r < R; ++r) mx[r] = NEG_INF;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2 * R; ++e) {
      if (!((mask >> (8 * j + 2 * t + (e & 1))) & 1u)) s[j][e] = NEG_INF;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    const float alpha = ex2(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[j][2 * r] *= alpha;
      acc[j][2 * r + 1] *= alpha;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float p[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = (mask >> (8 * j + 2 * t + e)) & 1u;
        p[e] = ok ? ex2(s[j][2 * r + e] - m[r]) : 0.f;
      }
      l[r] += p[0] + p[1];
      pa[j / 2][(j & 1) * 2 + r] = pack_bf16(p[0] * vs(j, 0), p[1] * vs(j, 1));
    }
}

// A warp's pass over its bf16 tiles (K2): the G query rows are rows
// 0..G-1 of a 16-row m16n8k16 m-tile (rows past G zero, their outputs
// dropped); S = Q K^T is DH/16 x 4 mmas, P.V 2 x DH/8, every operand read
// by ldmatrix from the swizzled tiles. This thread holds rows g (and
// g + 8 where R = 2).
template <int DH, int R>
struct Sm90Pass {
  static constexpr int KD = DH / 16, ND = DH / 8;
  float acc[ND][2 * R];
  float m[R], l[R];  // running max (log2 units), this thread's row sums

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 2 * R; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m[r] = NEG_INF;
      l[r] = 0.f;
    }
  }

  // mask: bit i set iff slot i of the tile is valid
  __device__ __forceinline__ void tile(uint32_t qs, uint32_t kt, uint32_t vt,
                                       const float*, unsigned mask,
                                       float scale_log2, int lane) {
    const int t = lane % 4;
    const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int a_col = lane >> 4;
    const int k_row = (lane & 7) + (lane >> 4) * 8;
    const int k_col = (lane >> 3) & 1;
    float s[4][2 * R];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2 * R; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, qs + sw_at<128, SM90_MAX_GROUP>(a_row, 2 * kk + a_col));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bb[4];
        ldsm_x4(bb, kt + sw_at<128, TS>(np * 16 + k_row, 2 * kk + k_col));
        mma_rows<R>(s[2 * np], a, bb[0], bb[1]);
        mma_rows<R>(s[2 * np + 1], a, bb[2], bb[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2 * R; ++e) s[j][e] *= scale_log2;
    uint32_t pa[2][4];
    online_softmax<R>(s, acc, m, l, pa, mask, t,
                      [](int, int) { return 1.f; });
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t bb[4];
        ldsm_x4_t(bb, vt + sw_at<128, TS>(kk * 16 + a_row, 2 * dp + a_col));
        mma_rows<R>(acc[2 * dp], pa[kk], bb[0], bb[1]);
        mma_rows<R>(acc[2 * dp + 1], pa[kk], bb[2], bb[3]);
      }
  }

  // the output column of accumulator (j, e)
  __device__ __forceinline__ static int col(int j, int e, int t) {
    return 8 * j + 2 * t + (e & 1);
  }
};

// A warp's pass over its int8 tiles (K3, bf16 q): Q8MmaPass's arithmetic,
// over all 16 rows of the m-tile where R = 2. S = Q K8^T takes the k
// dimension of each 16-wide k-step in an order of its own, the same for q
// and k: lane t's B registers are bytes 16kk + 4t .. + 3 of its slot's row
// (one 32-bit load), its A registers q[g][16kk + 4t .. + 3] (and q[g + 8]
// [...]), one 64-bit load a row. Each score column then takes its slot's k
// scale in f32. For P.V, p times the slot's v scale is rounded to bf16; a
// thread loads bytes 32blk + 4g .. + 3 of slot rows 16kk + 2t, + 1, + 8,
// + 9 and byte j of them is B of n-tile 4blk + j, so accumulator (j, e) of
// block blk is output column 32blk + 8t + 4(e & 1) + j.
template <int DH, int R>
struct Sm90Q8Pass {
  static constexpr int KD = DH / 16, ND = DH / 8, BW = DH;  // one box a row
  static constexpr int QROW = Sm90Shape<int8_t, DH>::QROW;
  float acc[ND][2 * R];
  float m[R], l[R];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 2 * R; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m[r] = NEG_INF;
      l[r] = 0.f;
    }
  }

  __device__ __forceinline__ void tile(uint32_t qs, uint32_t kt, uint32_t vt,
                                       const float* sc, unsigned mask,
                                       float scale_log2, int lane) {
    const int g = lane / 4, t = lane % 4;
    float s[4][2 * R];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2 * R; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                   : "=r"(a[0]), "=r"(a[2])
                   : "r"(qs + g * QROW + 32 * kk + 8 * t));
      if constexpr (R == 2)
        asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                     : "=r"(a[1]), "=r"(a[3])
                     : "r"(qs + (g + 8) * QROW + 32 * kk + 8 * t));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t w =
            lds32(kt + sw_at<BW, TS>(8 * j + g, kk) + 4 * t) ^ I8_BIAS;
        mma_rows<R>(s[j], a, bf16x2_exact(i8_at(w, 0), i8_at(w, 1)),
                    bf16x2_exact(i8_at(w, 2), i8_at(w, 3)));
      }
    }
    // score (j, e) is slot 8j + 2t + (e & 1): its k scale and dh^-0.5
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 ks = *reinterpret_cast<const float2*>(sc + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 2 * R; ++e)
        s[j][e] *= (e & 1 ? ks.y : ks.x) * scale_log2;
    }
    uint32_t pa[2][4];
    online_softmax<R>(s, acc, m, l, pa, mask, t, [&](int j, int e) {
      return sc[TS + 8 * j + 2 * t + e];
    });
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int r0 = 16 * kk + 2 * t;
#pragma unroll
      for (int blk = 0; blk < DH / 32; ++blk) {
        const int c = 2 * blk + (g >> 2), w = 4 * (g & 3);
        const uint32_t w0 = lds32(vt + sw_at<BW, TS>(r0, c) + w) ^ I8_BIAS;
        const uint32_t w1 =
            lds32(vt + sw_at<BW, TS>(r0 + 1, c) + w) ^ I8_BIAS;
        const uint32_t w8 =
            lds32(vt + sw_at<BW, TS>(r0 + 8, c) + w) ^ I8_BIAS;
        const uint32_t w9 =
            lds32(vt + sw_at<BW, TS>(r0 + 9, c) + w) ^ I8_BIAS;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_rows<R>(acc[4 * blk + j], pa[kk],
                      bf16x2_exact(i8_at(w0, j), i8_at(w1, j)),
                      bf16x2_exact(i8_at(w8, j), i8_at(w9, j)));
      }
    }
  }

  __device__ __forceinline__ static int col(int j, int e, int t) {
    return 32 * (j / 4) + 8 * t + 4 * (e & 1) + (j % 4);
  }
};

// One cluster of gridDim.x CTAs per batch*kv-head row (blockIdx.y); CTA
// rank r takes slots [r * chunk, min(S, (r + 1) * chunk)) in tiles of 32
// from its first slot. tk, tv: 4-D tensor maps (dh, KV, S, B) over the
// cache, boxes of BOX_W bytes x 1 head x 32 slots x 1 batch row (slots
// past S read as zeros). The CTA's k-th tile with a valid slot goes to
// stage k % n_stages, and each stage s to consumer warp s % SM90_WARPS
// alone: a warp waits on a stage's phases in order, so the parity of its
// wait is never one a phase ahead of the barrier, at any depth (every warp
// takes tiles where n_stages is a multiple of SM90_WARPS or at least the
// CTA's tiles; a shallower ring leaves warps idle). k_scale, v_scale:
// K3's (B, S, KV) scales, unread by K2. R: the rows of the m-tile a thread
// holds, 1 for G <= 8 (rows 8-15 zero), 2 for G up to 16.
template <typename C, int DH, int R>
__global__ void __launch_bounds__(SM90_THREADS, 2)
    decode_sm90(const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const bf16* __restrict__ q,
                const float* __restrict__ k_scale,
                const float* __restrict__ v_scale, bf16* __restrict__ o,
                int S, int KV, int G, int qg, int q0, int pos, int window,
                int ring, int chunk, int n_stages, float scale_log2) {
  using SH = Sm90Shape<C, DH>;
  using Pass =
      std::conditional_t<SH::Q8, Sm90Q8Pass<DH, R>, Sm90Pass<DH, R>>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* base_p = smem_raw + (base - smem_u32(smem_raw));
  const int n_ranks = gridDim.x, rank = blockIdx.x;
  const Sm90Layout ly = sm90_layout<C, DH>(G, n_ranks, n_stages);
  auto full = [&](int s) { return base + ly.bars + 8 * s; };
  auto empty = [&](int s) { return base + ly.bars + 8 * (n_stages + s); };
  float* scales = reinterpret_cast<float*>(base_p + ly.scales);
  float* ml = reinterpret_cast<float*>(base_p + ly.ml);
  float* part = reinterpret_cast<float*>(base_p);
  const float* gather = reinterpret_cast<const float*>(base_p + ly.gather);
  const float* gather_ml =
      reinterpret_cast<const float*>(base_p + ly.gather_ml);

  // every CTA of the cluster has started before any writes into another's
  // shared memory: arrive now, wait before the first remote write
  cluster_arrive_relaxed();
  const int bkv = blockIdx.y, b = bkv / KV, kvh = bkv % KV;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int s0 = rank * chunk, s1 = min(S, s0 + chunk);
  const int n_tiles = s1 > s0 ? (s1 - s0 + TS - 1) / TS : 0;
  // whether slot s is one this query attends to
  auto valid = [&](int s) {
    if (s >= s1) return false;
    const int sp = slot_position(s, S, pos, ring != 0);
    return sp >= 0 && sp <= pos && !(window > 0 && sp <= pos - window);
  };

  if (tid == 0) {
    for (int s = 0; s < n_stages; ++s) {
      // K3: the expect_tx arrival and the 32 lanes' scale copies
      mbar_init(full(s), SH::Q8 ? 33 : 1);
      mbar_init(empty(s), 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == SM90_WARPS) {
    // the producer warp: lane 0 loads each tile that has a valid slot by
    // TMA into the next stage once its consumer has released it; for K3
    // each lane copies its slot's two scales by cp.async, which arrives on
    // the same barrier when they land. Its lanes take part in both
    // cluster barriers.
    int k = 0;
    for (int i = 0; i < n_tiles; ++i) {
      const int first = s0 + i * TS;
      const unsigned mask = __ballot_sync(0xffffffffu, valid(first + lane));
      if (mask == 0) continue;  // no valid slot: nothing read
      const int st = k % n_stages;
      if (k >= n_stages) mbar_wait(empty(st), (k / n_stages - 1) & 1);
      if (lane == 0) {
        const uint32_t kd = base + st * SH::STAGE, vd = kd + SH::TILE;
        mbar_expect_tx(full(st), 2 * SH::TILE);
#pragma unroll
        for (int x = 0; x < SH::ROW / SH::BOX_W; ++x) {
          const int c0 = x * SH::BOX_W / (int)sizeof(C);
          tma_load_4d(kd + x * SH::BOX, &tk, full(st), c0, kvh, first, b);
          tma_load_4d(vd + x * SH::BOX, &tv, full(st), c0, kvh, first, b);
        }
      }
      if constexpr (SH::Q8) {
        const bool ok = (mask >> lane) & 1u;
        const size_t off =
            ((size_t)b * S + (ok ? first + lane : 0)) * KV + kvh;
        const uint32_t sd = smem_u32(scales + st * 2 * TS + lane);
        cp_async4(sd, k_scale + off, ok);
        cp_async4(sd + 4 * TS, v_scale + off, ok);
        cp_async_mbar_arrive(full(st));
      }
      ++k;
    }
    cluster_wait();
    cluster_arrive();
    cluster_wait();
    return;
  }

  // the consumers: q's G rows into shared memory, rows past G zero
  {
    constexpr int CPR = DH / 8;  // 16-byte chunks of a q row
    const bf16* qrow0 = q + ((size_t)bkv * qg + q0) * DH;
    for (int i = tid; i < SM90_MAX_GROUP * CPR; i += 32 * SM90_WARPS) {
      const int r = i / CPR, c = i % CPR;
      const uint4 x = r < G ? *reinterpret_cast<const uint4*>(
                                  qrow0 + (size_t)r * DH + c * 8)
                            : make_uint4(0u, 0u, 0u, 0u);
      const int at = SH::Q8 ? r * SH::QROW + c * 16
                            : sw_at<128, SM90_MAX_GROUP>(r, c);
      *reinterpret_cast<uint4*>(base_p + ly.q + at) = x;
    }
    named_bar_sync(SM90_BAR, 32 * SM90_WARPS);
  }

  Pass pass;
  pass.init();
  int k = 0;
  for (int i = 0; i < n_tiles; ++i) {
    const unsigned mask =
        __ballot_sync(0xffffffffu, valid(s0 + i * TS + lane));
    if (mask == 0) continue;
    const int kk = k++;
    const int st = kk % n_stages;
    if (st % SM90_WARPS != warp) continue;
    mbar_wait(full(st), (kk / n_stages) & 1);
    const uint32_t kt = base + st * SH::STAGE;
    pass.tile(base + ly.q, kt, kt + SH::TILE, scales + st * 2 * TS, mask,
              scale_log2, lane);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }

  // the CTA's merge: each warp's (m, l) of its rows; once every tile is
  // consumed (the ring is free), its acc rescaled to the CTA's max into
  // its slot of the partials
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float lr = pass.l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = g + 8 * r;
    if (t == 0 && row < G) {
      ml[(warp * G + row) * 2] = pass.m[r];
      ml[(warp * G + row) * 2 + 1] = lr;
    }
  }
  named_bar_sync(SM90_BAR, 32 * SM90_WARPS);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = g + 8 * r;
    if (row >= G) continue;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < SM90_WARPS; ++w) M = fmaxf(M, ml[(w * G + row) * 2]);
    const float f = ex2(pass.m[r] - M);
    float* dst = part + (warp * G + row) * DH;
#pragma unroll
    for (int j = 0; j < Pass::ND; ++j) {
      dst[Pass::col(j, 2 * r, t)] = pass.acc[j][2 * r] * f;
      dst[Pass::col(j, 2 * r + 1, t)] = pass.acc[j][2 * r + 1] * f;
    }
  }
  named_bar_sync(SM90_BAR, 32 * SM90_WARPS);

  // the reduce-scatter: rank r receives only its share of the G x DH
  // outputs (summed over the warps) and every row's (M, L)
  cluster_wait();
  const int share = ly.share;
  const uint32_t gat = base + ly.gather, gml = base + ly.gather_ml;
  for (int i = 4 * tid; i < G * DH; i += 4 * 32 * SM90_WARPS) {
    float4 a = *reinterpret_cast<const float4*>(part + i);
#pragma unroll
    for (int w = 1; w < SM90_WARPS; ++w) {
      const float4 x =
          *reinterpret_cast<const float4*>(part + w * G * DH + i);
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
    }
    const int dst = i / share;
    st_dsmem4(mapa(gat + 4 * (rank * share + i - dst * share), dst), a);
  }
  for (int i = tid; i < G * n_ranks; i += 32 * SM90_WARPS) {
    const int row = i % G, dst = i / G;
    float M = NEG_INF, L = 0.f;
#pragma unroll
    for (int w = 0; w < SM90_WARPS; ++w) M = fmaxf(M, ml[(w * G + row) * 2]);
#pragma unroll
    for (int w = 0; w < SM90_WARPS; ++w)
      L += ml[(w * G + row) * 2 + 1] * ex2(ml[(w * G + row) * 2] - M);
    st_dsmem2(mapa(gml + 8 * (rank * G + row), dst), M, L);
  }
  cluster_arrive();
  cluster_wait();

  // this rank's share: the ranks' partials merged in rank order,
  // normalised and stored
  const int i_end = min(G * DH, (rank + 1) * share);
  for (int i = rank * share + 4 * tid; i < i_end;
       i += 4 * 32 * SM90_WARPS) {
    const int row = i / DH;
    float M = NEG_INF;
    for (int r = 0; r < n_ranks; ++r)
      M = fmaxf(M, gather_ml[(r * G + row) * 2]);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    float L = 0.f;
    for (int r = 0; r < n_ranks; ++r) {
      const float f = ex2(gather_ml[(r * G + row) * 2] - M);
      const float4 x = *reinterpret_cast<const float4*>(
          gather + r * share + i - rank * share);
      a.x += x.x * f;
      a.y += x.y * f;
      a.z += x.z * f;
      a.w += x.w * f;
      L += gather_ml[(r * G + row) * 2 + 1] * f;
    }
    const float inv = 1.f / fmaxf(L, 1e-30f);
    *reinterpret_cast<uint2*>(o + ((size_t)bkv * qg + q0 + row) * DH +
                              i % DH) =
        make_uint2(pack_bf16(a.x * inv, a.y * inv),
                   pack_bf16(a.z * inv, a.w * inv));
  }
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

// The 4-D map (dh, KV, S, B), innermost first, over a cache of C in the
// model layout (B, S, KV, dh): boxes of BOX_W bytes x 1 kv head x 32 slots
// x 1 batch row, swizzled by BOX_W bytes. Keeping S and B apart makes TMA
// zero-fill a tile's slots past S instead of reading the next batch row.
template <typename C, int DH>
cudaError_t make_cache_map(CUtensorMap* map, const void* ptr, int KV, int S,
                           int B) {
  using SH = Sm90Shape<C, DH>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  constexpr cuuint64_t es = sizeof(C);
  const cuuint64_t dims[4] = {(cuuint64_t)DH, (cuuint64_t)KV, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {DH * es, (cuuint64_t)KV * DH * es,
                                 (cuuint64_t)S * KV * DH * es};
  const cuuint32_t box[4] = {(cuuint32_t)(SH::BOX_W / es), 1, TS, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map,
      SH::Q8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
             : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      SH::BOX_W == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                       : CU_TENSOR_MAP_SWIZZLE_64B,
      SH::ROW > 128 ? CU_TENSOR_MAP_L2_PROMOTION_L2_256B
                    : CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// decode_sm90's dynamic shared memory: the layout and its alignment slack
template <typename C, int DH>
size_t sm90_smem(int G, int n, int stages) {
  return sm90_layout<C, DH>(G, n, stages).total + 1024;
}

// Let decode_sm90<C, DH, R> take the device's opt-in shared memory and
// clusters of up to SM90_MAX_CLUSTER CTAs: once per device.
template <typename C, int DH, int R>
cudaError_t sm90_attributes() {
  static std::once_flag once[MAX_DEVICES];
  static cudaError_t result[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [dev] {
    int optin = 0;
    cudaError_t e = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(decode_sm90<C, DH, R>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(decode_sm90<C, DH, R>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    result[dev] = e;
  });
  return result[dev];
}

// The launch configuration of decode_sm90: a cluster of n CTAs a row
void sm90_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attr)[1],
                 int n, int rows, size_t smem, cudaStream_t stream) {
  cfg = {};
  cfg.gridDim = dim3(n, rows);
  cfg.blockDim = dim3(SM90_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

std::atomic<long long> n_launches[2];  // device launches by kernel code

template <typename C, int DH, int R>
cudaError_t launch_rows(const CUtensorMap& tk, const CUtensorMap& tv,
                        const void* q, const void* ks, const void* vs,
                        void* o, int B, int S, int G, int KV, int qg, int q0,
                        int pos, int window, int ring, int n_ctas, int chunk,
                        int n_stages, float scale, cudaStream_t stream) {
  cudaError_t err = sm90_attributes<C, DH, R>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  sm90_config(cfg, attr, n_ctas, B * KV,
              sm90_smem<C, DH>(G, n_ctas, n_stages), stream);
  return cudaLaunchKernelEx(
      &cfg, decode_sm90<C, DH, R>, tk, tv, static_cast<const bf16*>(q),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<bf16*>(o), S, KV, G, qg, q0, pos, window, ring, chunk,
      n_stages, scale * LOG2E);
}

template <typename C, int DH>
cudaError_t launch_sm90(const void* q, const void* k, const void* ks,
                        const void* v, const void* vs, void* o, int B, int S,
                        int H, int KV, int qg, int q0, int pos, int window,
                        int ring, int n_ctas, int chunk, int n_stages,
                        float scale, cudaStream_t stream) {
  using SH = Sm90Shape<C, DH>;
  const int G = H / KV;
  if (G > SM90_MAX_GROUP || n_ctas < 1 || n_ctas > SM90_MAX_CLUSTER ||
      chunk < 1 || (long)n_ctas * chunk < S || n_stages < 1 ||
      n_stages > SH::MAX_STAGES || (long)B * KV > 65535)
    return cudaErrorInvalidValue;
  CUtensorMap tk, tv;
  cudaError_t err = make_cache_map<C, DH>(&tk, k, KV, S, B);
  if (err == cudaSuccess) err = make_cache_map<C, DH>(&tv, v, KV, S, B);
  if (err != cudaSuccess) return err;
  err = G > 8 ? launch_rows<C, DH, 2>(tk, tv, q, ks, vs, o, B, S, G, KV, qg,
                                      q0, pos, window, ring, n_ctas, chunk,
                                      n_stages, scale, stream)
              : launch_rows<C, DH, 1>(tk, tv, q, ks, vs, o, B, S, G, KV, qg,
                                      q0, pos, window, ring, n_ctas, chunk,
                                      n_stages, scale, stream);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err == cudaSuccess) ++n_launches[1];
  return err;
}

// The kernel codes of the C entries (ops.py KERNELS)
constexpr int CLUSTER = 0, SM90 = 1;

// K2 (C = T) or K3 (C = int8) by kernel code: decode_cluster at any
// supported (T, dh), decode_sm90 at bf16 and dh 64 or 128 only
template <typename T, typename C>
cudaError_t launch_kernel(int kernel, int dh, const void* q, const void* k,
                          const void* ks, const void* v, const void* vs,
                          void* o, int B, int S, int H, int KV, int qg,
                          int q0, int pos, int window, int ring, int n_ctas,
                          int chunk, int n_stages, float scale,
                          cudaStream_t stream) {
  if (kernel == CLUSTER) {
    const cudaError_t err =
        launch_dh<T, C>(dh, q, k, ks, v, vs, o, B, S, H, KV, qg, q0, pos,
                        window, ring, n_ctas, chunk, scale, stream);
    if (err == cudaSuccess) ++n_launches[0];
    return err;
  }
  if constexpr (std::is_same<T, bf16>::value) {
    if (kernel == SM90 && KV >= 1 && H % KV == 0 && q0 >= 0 &&
        q0 + H / KV <= qg) {
      if (dh == 64)
        return launch_sm90<C, 64>(q, k, ks, v, vs, o, B, S, H, KV, qg, q0,
                                  pos, window, ring, n_ctas, chunk, n_stages,
                                  scale, stream);
      if (dh == 128)
        return launch_sm90<C, 128>(q, k, ks, v, vs, o, B, S, H, KV, qg, q0,
                                   pos, window, ring, n_ctas, chunk,
                                   n_stages, scale, stream);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// K2 over a sub-group of each kv head's query group: q and o (B, 1,
// KV * qg, dh) hold qg query heads per kv head, and this launch attends
// with heads q0 .. q0 + H / KV - 1 of each group, in place; qg = H / KV,
// q0 = 0 is the whole group. k/v (B, S, KV, dh) of q's type, 16-byte
// aligned. dtype: 0 = f32, 1 = bf16. ring: 0 = full cache, 1 = ring.
// n_ctas CTAs per batch*kv-head row, one cluster, each over chunk slots
// (n_ctas * chunk >= S). kernel (ops.py::kernel_for): 0 = decode_cluster
// (any dtype and dh; H / KV at most 8, n_ctas 1-8; n_stages unread), 1 =
// decode_sm90 (bf16 at dh 64 and 128; H / KV at most 16, n_ctas 1-16,
// n_stages the ring's depth); any other combination is
// cudaErrorInvalidValue, never another kernel.
extern "C" int decode_attention_group_fwd(const void* q, const void* k,
                                          const void* v, void* o, int kernel,
                                          int dtype, int B, int S, int H,
                                          int KV, int qg, int q0, int dh,
                                          int pos, int window, int ring,
                                          int n_ctas, int chunk,
                                          int n_stages, float scale,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_kernel<float, float>(kernel, dh, q, k, nullptr, v, nullptr,
                                       o, B, S, H, KV, qg, q0, pos, window,
                                       ring, n_ctas, chunk, n_stages, scale,
                                       st);
  if (dtype == 1)
    return launch_kernel<bf16, bf16>(kernel, dh, q, k, nullptr, v, nullptr,
                                     o, B, S, H, KV, qg, q0, pos, window,
                                     ring, n_ctas, chunk, n_stages, scale,
                                     st);
  return cudaErrorInvalidValue;
}

// K3, as K2 with k/v (B, S, KV, dh) int8 (16-byte aligned) and
// k_scale/v_scale (B, S, KV) f32; q and o of type dtype.
extern "C" int decode_attention_q8_fwd(const void* q, const void* k,
                                       const void* k_scale, const void* v,
                                       const void* v_scale, void* o,
                                       int kernel, int dtype, int B, int S,
                                       int H, int KV, int qg, int q0, int dh,
                                       int pos, int window, int ring,
                                       int n_ctas, int chunk, int n_stages,
                                       float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_kernel<float, int8_t>(kernel, dh, q, k, k_scale, v,
                                        v_scale, o, B, S, H, KV, qg, q0, pos,
                                        window, ring, n_ctas, chunk,
                                        n_stages, scale, st);
  if (dtype == 1)
    return launch_kernel<bf16, int8_t>(kernel, dh, q, k, k_scale, v, v_scale,
                                       o, B, S, H, KV, qg, q0, pos, window,
                                       ring, n_ctas, chunk, n_stages, scale,
                                       st);
  return cudaErrorInvalidValue;
}

// The device launches this library has made of the kernel code's kernel
// (K2 and K3 together); -1 for another code.
extern "C" long long decode_attention_device_launches(int kernel) {
  return kernel >= 0 && kernel < 2 ? n_launches[kernel].load() : -1;
}

// decode_sm90's dynamic shared memory (bytes) over an int8 (q8 1) or bf16
// (q8 0) cache at head dim dh, G query heads a launch, clusters of n CTAs
// and a ring of `stages`; -1 for an uninstantiated kernel.
extern "C" long long decode_attention_sm90_smem(int q8, int dh, int G,
                                                int n, int stages) {
  if (q8 == 0 && dh == 64) return sm90_smem<bf16, 64>(G, n, stages);
  if (q8 == 0 && dh == 128) return sm90_smem<bf16, 128>(G, n, stages);
  if (q8 == 1 && dh == 64) return sm90_smem<int8_t, 64>(G, n, stages);
  if (q8 == 1 && dh == 128) return sm90_smem<int8_t, 128>(G, n, stages);
  return -1;
}

// How many clusters of n CTAs of decode_sm90 (as above; the instance for
// G's rows) the current card holds at once
// (cudaOccupancyMaxActiveClusters), or a negative error.
extern "C" int decode_attention_sm90_clusters(int q8, int dh, int G, int n,
                                              int stages) {
  const long long smem = decode_attention_sm90_smem(q8, dh, G, n, stages);
  if (smem < 0 || n < 1 || n > SM90_MAX_CLUSTER || stages < 1)
    return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
  int count = 0;
  const auto query = [&](auto kernel, cudaError_t attrs) {
    err = attrs;
    if (err != cudaSuccess) return;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    sm90_config(cfg, attr, n, 1, (size_t)smem, nullptr);
    err = cudaOccupancyMaxActiveClusters(&count, kernel, &cfg);
  };
#define SM90_QUERY(Q8, C, D)                                            \
  if (q8 == Q8 && dh == D) {                                            \
    if (G > 8)                                                          \
      query(decode_sm90<C, D, 2>, sm90_attributes<C, D, 2>());          \
    else                                                                \
      query(decode_sm90<C, D, 1>, sm90_attributes<C, D, 1>());          \
  }
  SM90_QUERY(0, bf16, 64)
  SM90_QUERY(0, bf16, 128)
  SM90_QUERY(1, int8_t, 64)
  SM90_QUERY(1, int8_t, 128)
#undef SM90_QUERY
  return err == cudaSuccess ? count : -(int)err;
}
