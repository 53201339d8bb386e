// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces: paddle_tpu/kernels/flash_attention.py:_fwd_kernel (launched by
// _fwd), dropout included.
//
// Computes, per (b*h, query row i):
//   s_ij = scale * q_i . k_j + bias[b, j]        (bias optional, [B, Sk])
//   s_ij = -1e30 where causal and q_offset + i < k_offset + j
//   p_ij = softmax_j(s_i),  lse_i = log sum_j exp(s_ij)
//   o_i  = sum_j drop_ij p_ij v_j, drop_ij = keep_ij / (1 - rate) (or 1)
// The dropout mask (attention_common.cuh) multiplies the probabilities
// after their normaliser is summed, as _fwd_kernel does; lse is not
// dropped. A row that sees no key (every s_ij masked) gives o_i = 0,
// lse_i = -inf. q [BH, Sq, D]; k, v [BH, Sk, D]; o [BH, Sq, D] (f32 or
// bf16, the type of q); lse [BH, Sq] f32.  Sums, max and the accumulator
// are f32 in both cases.
//
// What bounds it on the H100: operations.  About 4 * D FLOPs per visible
// (query, key) pair against 4 * BH * S * D elements of q/k/v/o: far above
// the ridge at the main paths' shapes (serving prefill BH = 96, S = 128 ..
// 512, causal; BERT training BH = 384, S = 128, with dropout; BERT
// inference BH = 384, S = 512; D = 64).  f32 runs on the CUDA cores
// (67 TFLOP/s, plain f32 FMAs, no TF32); bf16 on the tensor cores.
// Dropout adds one Philox4x32-10 (about 60 integer instructions) per
// visible pair.
//
// What the design does about it.  Scores never leave the SM and device
// memory sees one read of q/k/v and one write of o.  A block owns 64 query
// rows and walks the keys in 64-row tiles; K and V tiles are double-
// buffered in shared memory and fed by cp.async, so tile t+1 loads while
// tile t is multiplied.  Under causal, k-tiles wholly above the diagonal
// are never loaded.  The head dim is a compile-time DP of 64 or 128: a
// smaller D is zero-padded up to it as the tiles load (pads add zeros to
// every dot product and are never stored).
//
// * f32 route: 256 threads as 16 row groups x 16 column groups.  Thread
//   (ty, tx) owns score rows ty*4 + i and columns tx + 16*j (a 4 x 4 patch)
//   and the same rows' output columns g*64 + tx*4 + e.  Q and K sit in
//   shared memory as they lie ([row][d], rows padded by 16 bytes), and the
//   score loop reads four d at a time of each of its rows as float4s: 64
//   FMAs for 8 shared loads.  The online softmax reduces each row across
//   its 16 column threads with warp shuffles.  P goes to shared memory
//   transposed ([key][row], written and read by the same warp), and P.V
//   reads one float4 of P and DP/64 float4s of V for every 16 * DP/64
//   FMAs.
// * bf16 route (FlashAttention-2 style): 4 warps, each owning 16 query
//   rows.  S = Q K^T with mma.sync.m16n8k16 (Q's fragments held in
//   registers for the whole key loop, K via ldmatrix); the online softmax
//   on the f32 score fragments (row reductions across the 4 lanes that
//   share a row); P stays in registers, dropped, cast to bf16 and used as
//   the A operand of P.V (V via ldmatrix.trans).  f32 accumulation
//   throughout.  wgmma and TMA are later work.

#include <math.h>

#include "attention_common.cuh"
#include "mma_common.cuh"

namespace {

using flash::dropout_keep;
using flash::load_rows;
using flash::NEG_INF;
using namespace sm90;

constexpr int BQ = 64;     // query rows a block
constexpr int BKV = 64;    // key rows a tile

// Scores live in the log2 domain (scale and bias times log2(e)), so each
// probability is one exp2f; lse goes back to the natural log at the end.
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

struct Args {
  const float* bias;       // [B, Sk] or null
  float* lse;
  int Sq, Sk, D, num_heads, causal;
  float scale;             // the caller's scale times LOG2E
  int q_offset, k_offset;
  uint32_t seed, drop_threshold;
  float drop_scale;
};

// keys the block's rows can see at all: under causal, global key position
// k_offset + j <= q_offset + (last row of the block)
__device__ __forceinline__ int key_end(const Args& a, int q0) {
  if (!a.causal) return a.Sk;
  const int last_q = min(q0 + BQ, a.Sq) - 1;
  return max(0, min(a.Sk, a.q_offset + last_q - a.k_offset + 1));
}

// the masked, biased score of (row qi, key gj) from its raw dot product; b
// is the bias times LOG2E
__device__ __forceinline__ float score(const Args& a, float dot, float b,
                                       int qi, int gj) {
  float sv = dot * a.scale + b;
  if (a.causal && a.q_offset + qi < a.k_offset + gj) sv = NEG_INF;
  return sv;
}

// ------------------------------------------------------------ f32 route
constexpr int F32_THREADS = 256;

template <int DP>
struct F32Fwd {
  static constexpr int LD = DP + 4;            // floats, +16 bytes a row
  static constexpr int LDP = BQ + 4;
  static constexpr int NG = DP / 64;           // output column groups
  static constexpr int SMEM = 4 * ((BQ + 4 * BKV) * LD + BKV * LDP);
};

template <int DP, bool DROPOUT>
__global__ void __launch_bounds__(F32_THREADS, DP == 64 ? 2 : 1)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, Args a) {
  using F = F32Fwd<DP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);     // [BQ][LD]
  float* sK = sQ + BQ * F::LD;                        // [2][BKV][LD]
  float* sV = sK + 2 * BKV * F::LD;                   // [2][BKV][LD]
  float* sP = sV + 2 * BKV * F::LD;                   // [BKV][LDP], P^T

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int D = a.D;
  const long long qbase = (long long)bh * a.Sq * D;
  const long long kbase = (long long)bh * a.Sk * D;
  const float* brow =
      a.bias ? a.bias + (long long)(bh / a.num_heads) * a.Sk : nullptr;
  const int k_end = key_end(a, q0);
  const int ntiles = (k_end + BKV - 1) / BKV;

  load_rows<float, DP, F::LD, F32_THREADS>(sQ, q + qbase, q0, a.Sq, D);
  if (ntiles > 0) {
    load_rows<float, DP, F::LD, F32_THREADS>(sK, k + kbase, 0, a.Sk, D);
    load_rows<float, DP, F::LD, F32_THREADS>(sV, v + kbase, 0, a.Sk, D);
  }
  cp_commit();

  float acc[4][4 * F::NG];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int d = 0; d < 4 * F::NG; ++d) acc[i][d] = 0.f;
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) { m_run[i] = NEG_INF; l_run[i] = 0.f; }

  for (int t = 0; t < ntiles; ++t) {
    cp_wait<0>();                      // tile t (and Q) landed ...
    __syncthreads();                   // ... for all; tile t-1 consumed
    const int kt = t * BKV;
    if (t + 1 < ntiles) {
      const int nb = (t + 1) % 2;
      load_rows<float, DP, F::LD, F32_THREADS>(sK + nb * BKV * F::LD,
                                               k + kbase, kt + BKV, a.Sk, D);
      load_rows<float, DP, F::LD, F32_THREADS>(sV + nb * BKV * F::LD,
                                               v + kbase, kt + BKV, a.Sk, D);
    }
    cp_commit();
    const float* tK = sK + (t % 2) * BKV * F::LD;
    const float* tV = sV + (t % 2) * BKV * F::LD;

    // S = Q K^T for this thread's 4 x 4 patch
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int d4 = 0; d4 < DP; d4 += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(sQ + (ty * 4 + i) * F::LD +
                                                 d4);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = *reinterpret_cast<const float4*>(tK + (tx + 16 * j) * F::LD +
                                                 d4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        }
    }

    // online softmax, row by row; the row's 16 column threads are the
    // lanes tx = 0..15 of one half-warp
    float bj[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gj = kt + tx + 16 * j;
      bj[j] = brow && gj < a.Sk ? brow[gj] * LOG2E : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float m_tile = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gj = kt + tx + 16 * j;
        s[i][j] = score(a, s[i][j], bj[j], qi, gj);
        if (gj < a.Sk) m_tile = fmaxf(m_tile, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, off));
      const float m_new = fmaxf(m_run[i], m_tile);
      const float m_safe = m_new > NEG_INF * 0.5f ? m_new : 0.f;
      const float corr = exp2f(m_run[i] - m_safe);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gj = kt + tx + 16 * j;
        float p = gj < a.Sk ? exp2f(s[i][j] - m_safe) : 0.f;
        psum += p;                     // the normaliser sees every key
        if (DROPOUT)
          p = dropout_keep(a.seed, bh, qi, gj, a.drop_threshold)
                  ? p * a.drop_scale : 0.f;
        s[i][j] = p;
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l_run[i] = corr * l_run[i] + psum;
      m_run[i] = m_new;
#pragma unroll
      for (int d = 0; d < 4 * F::NG; ++d) acc[i][d] *= corr;
    }
    // P^T to shared memory: column tx + 16j of rows ty*4 .. ty*4+3; the
    // row group's 16 threads share a warp, which alone reads it back
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(sP + (tx + 16 * j) * F::LDP + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncwarp();

    // O += P V
#pragma unroll 8
    for (int c = 0; c < BKV; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(sP + c * F::LDP +
                                                        ty * 4);
      const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int g = 0; g < F::NG; ++g) {
        const float4 vv = *reinterpret_cast<const float4*>(
            tV + c * F::LD + g * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * g] = fmaf(pr[i], vv.x, acc[i][4 * g]);
          acc[i][4 * g + 1] = fmaf(pr[i], vv.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(pr[i], vv.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(pr[i], vv.w, acc[i][4 * g + 3]);
        }
      }
    }
  }
  cp_wait<0>();                        // nothing in flight at exit

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= a.Sq) continue;
    const float inv = l_run[i] > 0.f ? 1.f / l_run[i] : 0.f;
    float* orow = o + qbase + (long long)qi * D;
#pragma unroll
    for (int g = 0; g < F::NG; ++g) {
      const int d = g * 64 + tx * 4;
      if (d < D)                       // D % 8 == 0: all four or none
        *reinterpret_cast<float4*>(orow + d) = make_float4(
            acc[i][4 * g] * inv, acc[i][4 * g + 1] * inv,
            acc[i][4 * g + 2] * inv, acc[i][4 * g + 3] * inv);
    }
    if (tx == 0)
      a.lse[(long long)bh * a.Sq + qi] =
          l_run[i] > 0.f ? (m_run[i] + log2f(l_run[i])) * LN2 : -INFINITY;
  }
}

// ------------------------------------------------------------ bf16 route
constexpr int BF_THREADS = 128;

template <int DP>
struct BfFwd {
  static constexpr int LD = DP + 8;            // bf16s, +16 bytes a row
  static constexpr int SMEM = 2 * (BQ + 4 * BKV) * LD;
};

template <int DP, bool DROPOUT>
__global__ void __launch_bounds__(BF_THREADS)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, Args a) {
  using F = BfFwd<DP>;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);       // [BQ][LD]
  bf16* sK = sQ + BQ * F::LD;                         // [2][BKV][LD]
  bf16* sV = sK + 2 * BKV * F::LD;                    // [2][BKV][LD]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int D = a.D;
  const long long qbase = (long long)bh * a.Sq * D;
  const long long kbase = (long long)bh * a.Sk * D;
  const float* brow =
      a.bias ? a.bias + (long long)(bh / a.num_heads) * a.Sk : nullptr;
  const int k_end = key_end(a, q0);
  const int ntiles = (k_end + BKV - 1) / BKV;
  // this lane's two rows (h = 0, 1) of the warp's 16
  int qrow[2];
  qrow[0] = q0 + warp * 16 + lane / 4;
  qrow[1] = qrow[0] + 8;

  load_rows<bf16, DP, F::LD, BF_THREADS>(sQ, q + qbase, q0, a.Sq, D);
  if (ntiles > 0) {
    load_rows<bf16, DP, F::LD, BF_THREADS>(sK, k + kbase, 0, a.Sk, D);
    load_rows<bf16, DP, F::LD, BF_THREADS>(sV, v + kbase, 0, a.Sk, D);
  }
  cp_commit();

  uint32_t qf[DP / 16][4];
  float acc[DP / 8][4];
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    cp_wait<0>();
    __syncthreads();
    const int kt = t * BKV;
    if (t == 0) {
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks)
        ldmatrix_x4(qf[ks], sQ + (warp * 16 + lane % 16) * F::LD + ks * 16 +
                                (lane / 16) * 8);
    }
    if (t + 1 < ntiles) {
      const int nb = (t + 1) % 2;
      load_rows<bf16, DP, F::LD, BF_THREADS>(sK + nb * BKV * F::LD,
                                             k + kbase, kt + BKV, a.Sk, D);
      load_rows<bf16, DP, F::LD, BF_THREADS>(sV + nb * BKV * F::LD,
                                             v + kbase, kt + BKV, a.Sk, D);
    }
    cp_commit();
    const bf16* tK = sK + (t % 2) * BKV * F::LD;
    const bf16* tV = sV + (t % 2) * BKV * F::LD;

    // S = Q K^T: 8 tiles of 16 x 8 across the 64 keys
    float s[BKV / 8][4];
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks)
#pragma unroll
      for (int nt = 0; nt < BKV / 8; nt += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, tK + (nt * 8 + lane % 8 + (lane / 16) * 8) * F::LD +
                           ks * 16 + ((lane / 8) % 2) * 8);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_bf16(s[nt], qf[ks], b0);
        mma_bf16(s[nt + 1], qf[ks], b1);
      }

    // online softmax on the fragments; a row's 16 values of this tile lie
    // in the 4 lanes that share lane / 4
    float bj[BKV / 8][2];
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gj = kt + nt * 8 + (lane % 4) * 2 + e;
        bj[nt][e] = brow && gj < a.Sk ? brow[gj] * LOG2E : 0.f;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = qrow[h];
      float m_tile = NEG_INF;
#pragma unroll
      for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gj = kt + nt * 8 + (lane % 4) * 2 + e;
          float& sv = s[nt][2 * h + e];
          sv = score(a, sv, bj[nt][e], qi, gj);
          if (gj < a.Sk) m_tile = fmaxf(m_tile, sv);
        }
      m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 1));
      m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 2));
      const float m_new = fmaxf(m_run[h], m_tile);
      const float m_safe = m_new > NEG_INF * 0.5f ? m_new : 0.f;
      const float corr = exp2f(m_run[h] - m_safe);
      float psum = 0.f;
#pragma unroll
      for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gj = kt + nt * 8 + (lane % 4) * 2 + e;
          float& sv = s[nt][2 * h + e];
          float p = gj < a.Sk ? exp2f(sv - m_safe) : 0.f;
          psum += p;
          if (DROPOUT)
            p = dropout_keep(a.seed, bh, qi, gj, a.drop_threshold)
                    ? p * a.drop_scale : 0.f;
          sv = p;
        }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      l_run[h] = corr * l_run[h] + psum;
      m_run[h] = m_new;
#pragma unroll
      for (int nt = 0; nt < DP / 8; ++nt) {
        acc[nt][2 * h] *= corr;
        acc[nt][2 * h + 1] *= corr;
      }
    }

    // O += P V: P's fragments of keys 16kk .. 16kk+15 are the A operand
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nt = 0; nt < DP / 8; nt += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(
            r, tV + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * F::LD +
                   nt * 8 + (lane / 16) * 8);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_bf16(acc[nt], pa, b0);
        mma_bf16(acc[nt + 1], pa, b1);
      }
    }
  }
  cp_wait<0>();                        // nothing in flight at exit

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = qrow[h];
    if (qi >= a.Sq) continue;
    const float inv = l_run[h] > 0.f ? 1.f / l_run[h] : 0.f;
    bf16* orow = o + qbase + (long long)qi * D;
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt) {
      const int d = nt * 8 + (lane % 4) * 2;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(
            acc[nt][2 * h] * inv, acc[nt][2 * h + 1] * inv);
    }
    if (lane % 4 == 0)
      a.lse[(long long)bh * a.Sq + qi] =
          l_run[h] > 0.f ? (m_run[h] + log2f(l_run[h])) * LN2 : -INFINITY;
  }
}

// ------------------------------------------------------------ launch
template <typename T>
int run(void (*kernel)(const T*, const T*, const T*, T*, Args), int threads,
        int smem, const void* q, const void* k, const void* v, void* o,
        const Args& a, int BH, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sq + BQ - 1) / BQ, BH);
  kernel<<<grid, threads, smem, stream>>>((const T*)q, (const T*)k,
                                          (const T*)v, (T*)o, a);
  return (int)cudaGetLastError();
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o,
           const Args& a, int BH, int is_bf16, cudaStream_t s) {
  const bool drop = a.drop_scale > 0.f;
  if (is_bf16)
    return run<__nv_bfloat16>(drop ? flash_fwd_bf16<DP, true>
                                   : flash_fwd_bf16<DP, false>,
                              BF_THREADS, BfFwd<DP>::SMEM, q, k, v, o, a, BH,
                              s);
  return run<float>(drop ? flash_fwd_f32<DP, true> : flash_fwd_f32<DP, false>,
                    F32_THREADS, F32Fwd<DP>::SMEM, q, k, v, o, a, BH, s);
}

}  // namespace

// seed and drop_threshold are 32-bit words passed as ints; drop_scale is
// 1 / (1 - rate), or 0 for no dropout.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* bias, void* o,
                                   void* lse, int BH, int Sq, int Sk, int D,
                                   int num_heads, int causal, float scale,
                                   int q_offset, int k_offset, int is_bf16,
                                   int seed, int drop_threshold,
                                   float drop_scale, void* stream) {
  if (D < 8 || D > 128 || D % 8 || BH < 1 || Sq < 1 || Sk < 1)
    return (int)cudaErrorInvalidValue;
  Args a{(const float*)bias, (float*)lse, Sq, Sk, D, num_heads, causal,
         scale * LOG2E, q_offset, k_offset, (uint32_t)seed,
         (uint32_t)drop_threshold, drop_scale};
  cudaStream_t s = (cudaStream_t)stream;
  return D <= 64 ? launch<64>(q, k, v, o, a, BH, is_bf16, s)
                 : launch<128>(q, k, v, o, a, BH, is_bf16, s);
}
