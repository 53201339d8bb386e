// Shared by the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_dq.cu, flash_attention_dkv.cu): the dropout mask, the
// cp.async row loader of their tiles, and what the two backward kernels
// share (their arguments, the recomputed score, the f32 route's register
// tiles).
//
// Dropout mask: Philox4x32-10 (Salmon et al., SC'11) with counter
// (col, row, bh, 0) and key (seed, 0); element (row, col) of head bh is
// kept iff the first output word >= threshold = round(rate * 2^32). It is
// a function of the element alone, not of the tiling, so the forward and
// both backward kernels drop the same elements, and so does the plain
// PyTorch version (kernels/flash_attention.py: philox4x32_10,
// dropout_keep), bit for bit. It replaces the TPU kernel's on-core PRNG
// reseeded per (bh, q-block, k-block) (_dropout_keep in
// paddle_tpu/kernels/flash_attention.py), whose bits depend on the blocks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace flash {

constexpr float NEG_INF = -1e30f;      // finite mask sentinel
constexpr float LOG2E = 1.4426950408889634f;

// First output word of Philox4x32-10.
__device__ __forceinline__ uint32_t philox_word0(uint32_t c0, uint32_t c1,
                                                 uint32_t c2, uint32_t c3,
                                                 uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

__device__ __forceinline__ bool dropout_keep(uint32_t seed, int bh, int row,
                                             int col, uint32_t threshold) {
  return philox_word0((uint32_t)col, (uint32_t)row, (uint32_t)bh, 0u, seed,
                      0u) >= threshold;
}

// Copy rows [row0, row0 + 64) of a [rows, D] matrix into a tile of DP
// columns (row stride LD elements) with cp.async, zeros past the last row
// and past D.  D % 8 == 0, so a chunk (16 bytes: 4 f32 or 8 bf16) is
// wholly inside or wholly outside.
template <typename T, int DP, int LD, int THREADS>
__device__ __forceinline__ void load_rows(T* tile, const T* src, int row0,
                                          int rows, int D) {
  constexpr int PER = 16 / sizeof(T);          // elements a chunk
  constexpr int CHUNKS = 64 * DP / PER;
  static_assert(CHUNKS % THREADS == 0, "whole copy rounds");
#pragma unroll
  for (int it = 0; it < CHUNKS / THREADS; ++it) {
    const int idx = threadIdx.x + it * THREADS;
    const int r = idx / (DP / PER), c = (idx % (DP / PER)) * PER;
    const int g = row0 + r;
    const bool in = g < rows && c < D;
    sm90::cp_async16(tile + r * LD + c, in ? src + (long long)g * D + c : src,
                     in);
  }
}

// ------------------------------------------------------- backward kernels
// What K3 (flash_attention_dq.cu) and K4 (flash_attention_dkv.cu) take.
struct BwdArgs {
  const float* bias;       // [B, Sk] or null
  const float* lse;        // [BH, Sq]
  const float* delta;      // [BH, Sq]
  int Sq, Sk, D, num_heads, causal;
  float scale;
  int q_offset, k_offset;
  uint32_t seed, drop_threshold;
  float drop_scale;        // 1 / (1 - rate), 0: no dropout
};

// The masked score of (query qi, key kj) from its raw dot product and the
// key's bias b, rounded as the plain version rounds it (the product, then
// the sum).  A key past Sk is masked like a causal one, so its P is 0.
__device__ __forceinline__ float score(const BwdArgs& a, float dot, float b,
                                       int qi, int kj) {
  if (kj >= a.Sk || (a.causal && a.q_offset + qi < a.k_offset + kj))
    return NEG_INF;
  return __fadd_rn(__fmul_rn(dot, a.scale), b);
}

// The lse a row's P is taken against: a dead row (lse = -inf) and a row
// past Sq get +1e30, so every P of theirs is 0.
__device__ __forceinline__ float lse_of(float l, bool in) {
  return in && isfinite(l) ? l : -NEG_INF;
}

// One (P, dP) pair's terms: P = exp(s - lse), taken as exp2 of the
// difference in the natural domain (lse comes from the forward, and with
// a padding bias of -10000 both s and lse are large: subtracting first
// keeps P as exact as the plain version's); dP dropped.  Returns P and
// leaves the dropped P in *p_used and the dropped dP in *dp.  Philox runs
// only where P != 0 (a zero P zeroes both products whatever the mask).
template <bool DROPOUT>
__device__ __forceinline__ float bwd_p(const BwdArgs& a, float s, float lse,
                                       int bh, int qi, int kj, float* dp,
                                       float* p_used) {
  const float p = exp2f((s - lse) * LOG2E);
  *p_used = p;
  if (DROPOUT && p != 0.f) {
    const bool keep = dropout_keep(a.seed, bh, qi, kj, a.drop_threshold);
    *p_used = keep ? p * a.drop_scale : 0.f;
    *dp = keep ? *dp * a.drop_scale : 0.f;
  }
  return p;
}

// f32 route: 256 threads as 16 row groups ty x 16 column groups tx.
// c[i][j] = A[ty*4 + i] . B[tx + 16 j] over DP, A and B as they lie in
// shared memory ([row][LD], LD = DP + 4), read four d at a time as float4s
// (64 FMAs for 8 shared loads).
template <int DP, int LD>
__device__ __forceinline__ void dot_patch(float c[4][4], const float* A,
                                          const float* B, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
#pragma unroll
  for (int d4 = 0; d4 < DP; d4 += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float4*>(A + (ty * 4 + i) * LD + d4);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      y[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * LD + d4);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[i][j] = fmaf(x[i].x, y[j].x, c[i][j]);
        c[i][j] = fmaf(x[i].y, y[j].y, c[i][j]);
        c[i][j] = fmaf(x[i].z, y[j].z, c[i][j]);
        c[i][j] = fmaf(x[i].w, y[j].w, c[i][j]);
      }
  }
}

// Write a 4 x 4 patch c[i][j] (row ty*4 + i, column tx + 16 j) transposed
// into T ([column][LDT]): the row group's 16 threads, one half-warp, own
// columns ty*4 .. ty*4+3 of T and alone read them back (acc_patch).
template <int LDT>
__device__ __forceinline__ void store_patch_t(float* T, float c[4][4],
                                              int ty, int tx) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(T + (tx + 16 * j) * LDT + ty * 4) =
        make_float4(c[0][j], c[1][j], c[2][j], c[3][j]);
}

// acc[i][4g + e] += sum_c T[c][ty*4 + i] * M[c][g*64 + tx*4 + e] over the
// 64 rows c of M ([row][LD]): one float4 of T and DP/64 of M for every
// 16 * DP/64 FMAs.
template <int DP, int LD, int LDT>
__device__ __forceinline__ void acc_patch(float (&acc)[4][DP / 16],
                                          const float* T, const float* M,
                                          int ty, int tx) {
#pragma unroll 8
  for (int c = 0; c < 64; ++c) {
    const float4 t = *reinterpret_cast<const float4*>(T + c * LDT + ty * 4);
    const float tr[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int g = 0; g < DP / 64; ++g) {
      const float4 m =
          *reinterpret_cast<const float4*>(M + c * LD + g * 64 + tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][4 * g] = fmaf(tr[i], m.x, acc[i][4 * g]);
        acc[i][4 * g + 1] = fmaf(tr[i], m.y, acc[i][4 * g + 1]);
        acc[i][4 * g + 2] = fmaf(tr[i], m.z, acc[i][4 * g + 2]);
        acc[i][4 * g + 3] = fmaf(tr[i], m.w, acc[i][4 * g + 3]);
      }
    }
  }
}

// Store rows ty*4 + i (global row0 + ty*4 + i < rows) of a [rows, D] f32
// output, times mul, from acc as acc_patch lays it out.
template <int DP>
__device__ __forceinline__ void store_acc_f32(float* out,
                                              float (&acc)[4][DP / 16],
                                              int row0, int rows, int D,
                                              float mul, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= rows) continue;
    float* orow = out + (long long)r * D;
#pragma unroll
    for (int g = 0; g < DP / 64; ++g) {
      const int d = g * 64 + tx * 4;
      if (d < D)                       // D % 8 == 0: all four or none
        *reinterpret_cast<float4*>(orow + d) = make_float4(
            acc[i][4 * g] * mul, acc[i][4 * g + 1] * mul,
            acc[i][4 * g + 2] * mul, acc[i][4 * g + 3] * mul);
    }
  }
}

// bf16 route: store the m16n8 accumulator fragments acc[DP/8][4] of a
// warp's 16 rows (this lane's rows r[0], r[1]) to a [rows, D] bf16 output,
// times mul.
template <int DP>
__device__ __forceinline__ void store_acc_bf16(__nv_bfloat16* out,
                                               float (&acc)[DP / 8][4],
                                               const int r[2], int rows,
                                               int D, float mul, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r[h] >= rows) continue;
    __nv_bfloat16* orow = out + (long long)r[h] * D;
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt) {
      const int d = nt * 8 + (lane % 4) * 2;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(
            acc[nt][2 * h] * mul, acc[nt][2 * h + 1] * mul);
    }
  }
}

}  // namespace flash
