// Flash-attention backward, dQ, for Hopper (sm_90a), plain C interface.
//
// Replaces: paddle_tpu/kernels/flash_attention.py:_dq_kernel (launched by
// _bwd), dropout included.
//
// Computes, per (b*h, query row i), with P recomputed from the forward's
// log-sum-exp instead of stored:
//   s_ij  = scale * q_i . k_j + bias[b, j], -1e30 where causal masks it
//   p_ij  = exp(s_ij - lse_i)             (lse_i = -inf: p_ij = 0)
//   dp_ij = drop_ij * (do_i . v_j)         (drop_ij = keep_ij / (1 - rate))
//   ds_ij = p_ij * (dp_ij - delta_i),  delta_i = rowsum(do_i o_i) - dlse_i
//   dq_i  = scale * sum_j ds_ij k_j
// delta comes from the wrapper (kernels/flash_attention.py), as the
// reference computes it outside its kernel.  q, k, v, do, dq in the type of
// q (f32 or bf16); bias, lse, delta f32; all sums f32, plain f32 FMAs for
// f32 inputs (no TF32).  The dropout mask is attention_common.cuh's, the
// forward kernel's own.
//
// What bounds it on the H100: operations.  6 * D FLOPs per visible
// (query, key) pair (the score, dP and the dQ product) against one read of
// q, k, v, do and one write of dq; at BERT's [BH = 384, S = 128, D = 64]
// that is about 16 FLOP per f32 byte moved at S = 128 and grows with S,
// at or above the card's 20 FLOP/byte f32 ridge.  The f32 CUDA-core peak
// is 67 TFLOP/s.
//
// What the design does about it: one block per (64-row q-tile, bh) owns
// its dq rows, so no atomics and no second pass; the dq accumulator stays
// in registers across the k-tiles, and P and dS never leave the SM (one
// 64x64 dS tile in shared memory at a time).  Under causal, k-tiles wholly
// above the diagonal are never loaded.  No wgmma or TMA yet.
//
// Layout: 256 threads; thread t owns query row r = t / 4 of the tile and,
// with its 3 neighbours, the tile's 64 key columns (c = t % 4 + 4 * j) and
// the row's D dq columns (d = t % 4 + 4 * i).  Shared tiles are f32 with a
// padded row stride (D + 1).

#include <math.h>

#include "attention_common.cuh"

namespace {

using namespace flash;

template <typename T, bool DROPOUT>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ bias,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int Sq,
                int Sk, int D, int num_heads, int causal, float scale,
                int q_offset, int k_offset, uint32_t seed,
                uint32_t drop_threshold, float drop_scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* sQ = smem;                    // [BQ][ld]
  float* sdO = sQ + BQ * ld;           // [BQ][ld]
  float* sK = sdO + BQ * ld;           // [BK][ld]
  float* sV = sK + BK * ld;            // [BK][ld]
  float* sS = sV + BK * ld;            // [BQ][BK + 1]: dS of the tile
  const int ldp = BK + 1;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int r = tid / TPR;
  const int sub = tid % TPR;
  const int qi = q0 + r;
  const long long qbase = (long long)bh * Sq * D;
  const long long kbase = (long long)bh * Sk * D;
  const float* brow = bias ? bias + (long long)(bh / num_heads) * Sk : nullptr;

  load_tiles(sQ, sdO, q + qbase, dout + qbase, q0, Sq, D);
  // dead rows (lse = -inf) and rows past Sq: a finite +1e30 makes p = 0
  float lse_r = qi < Sq ? lse[(long long)bh * Sq + qi] : -INFINITY;
  const float lse_safe = isfinite(lse_r) ? lse_r : -NEG_INF;
  const float delta_r = qi < Sq ? delta[(long long)bh * Sq + qi] : 0.f;

  int k_end = Sk;
  if (causal) {
    int last_q = min(q0 + BQ, Sq) - 1;
    k_end = max(0, min(Sk, q_offset + last_q - k_offset + 1));
  }

  float acc[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < k_end; kt += BK) {
    __syncthreads();                   // previous tile fully consumed
    load_tiles(sK, sV, k + kbase, v + kbase, kt, Sk, D);
    __syncthreads();

#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = sub + TPR * j;
      const int gj = kt + c;
      float ds = 0.f;
      if (gj < Sk) {
        float dot = 0.f, dp = 0.f;
        for (int d = 0; d < D; ++d) {
          dot = fmaf(sQ[r * ld + d], sK[c * ld + d], dot);
          dp = fmaf(sdO[r * ld + d], sV[c * ld + d], dp);
        }
        float sv = dot * scale;
        if (brow) sv += brow[gj];
        if (causal && q_offset + qi < k_offset + gj) sv = NEG_INF;
        const float p = expf(sv - lse_safe);
        if (DROPOUT)
          dp = dropout_keep(seed, bh, qi, gj, drop_threshold)
                   ? dp * drop_scale : 0.f;
        ds = p * (dp - delta_r);
      }
      sS[r * ldp + c] = ds;
    }
    __syncwarp();                      // the row's 4 threads share a warp
    const int kn = min(BK, k_end - kt);
    for (int c = 0; c < kn; ++c) {
      const float ds = sS[r * ldp + c];
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        const int d = sub + TPR * i;
        if (d < D) acc[i] = fmaf(ds, sK[c * ld + d], acc[i]);
      }
    }
  }

  if (qi < Sq) {
    const long long obase = qbase + (long long)qi * D;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      const int d = sub + TPR * i;
      if (d < D) store(dq + obase + d, acc[i] * scale);
    }
  }
}

template <typename T, bool DROPOUT>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* dout, const void* lse, const void* delta, void* dq,
           int BH, int Sq, int Sk, int D, int num_heads, int causal,
           float scale, int q_offset, int k_offset, int seed,
           int drop_threshold, float drop_scale, cudaStream_t stream) {
  size_t smem = sizeof(float) * ((size_t)(2 * BQ + 2 * BK) * (D + 1) +
                                 (size_t)BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<T, DROPOUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, BH);
  flash_dq_kernel<T, DROPOUT><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)bias,
      (const T*)dout, (const float*)lse, (const float*)delta, (T*)dq, Sq, Sk,
      D, num_heads, causal, scale, q_offset, k_offset, (uint32_t)seed,
      (uint32_t)drop_threshold, drop_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// seed and drop_threshold are 32-bit words passed as ints; drop_scale is
// 1 / (1 - rate), or 0 for no dropout.
extern "C" int flash_attention_dq(const void* q, const void* k,
                                  const void* v, const void* bias,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dq, int BH,
                                  int Sq, int Sk, int D, int num_heads,
                                  int causal, float scale, int q_offset,
                                  int k_offset, int is_bf16, int seed,
                                  int drop_threshold, float drop_scale,
                                  void* stream) {
  if (D < 1 || D > MAX_D) return (int)cudaErrorInvalidValue;
  auto fn = is_bf16 ? (drop_scale > 0.f ? launch<__nv_bfloat16, true>
                                        : launch<__nv_bfloat16, false>)
                    : (drop_scale > 0.f ? launch<float, true>
                                        : launch<float, false>);
  return fn(q, k, v, bias, dout, lse, delta, dq, BH, Sq, Sk, D, num_heads,
            causal, scale, q_offset, k_offset, seed, drop_threshold,
            drop_scale, (cudaStream_t)stream);
}
