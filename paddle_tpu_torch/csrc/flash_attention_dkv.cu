// Flash-attention backward, dK and dV, for Hopper (sm_90a), plain C
// interface.
//
// Replaces: paddle_tpu/kernels/flash_attention.py:_dkv_kernel (launched by
// _bwd), dropout included.
//
// Computes, per (b*h, key row j), with P recomputed from the forward's
// log-sum-exp (the same terms as flash_attention_dq.cu):
//   p_ij  = exp(s_ij - lse_i)             (lse_i = -inf: p_ij = 0)
//   dp_ij = drop_ij * (do_i . v_j),  ds_ij = p_ij * (dp_ij - delta_i)
//   dv_j  = sum_i drop_ij p_ij do_i
//   dk_j  = scale * sum_i ds_ij q_i
// q, k, v, do, dk, dv in the type of q (f32 or bf16); bias, lse, delta
// f32; all sums f32, plain f32 FMAs for f32 inputs (no TF32).
//
// What bounds it on the H100: operations.  8 * D FLOPs per visible
// (query, key) pair (the score, dP, dV and dK products) against one read
// of q, k, v, do and one write of dk and dv: about 18 FLOP per f32 byte
// at BERT's S = 128, growing with S, near the card's 20 FLOP/byte f32
// ridge.  The f32 CUDA-core peak is 67 TFLOP/s.
//
// What the design does about it: one block per (64-row k-tile, bh) owns
// its dk and dv rows, so it needs no atomics: it walks the q-tiles and
// keeps both accumulators in registers.  P and dS never leave the SM (one
// 64x64 tile of each in shared memory at a time).  Under causal, q-tiles
// wholly before the tile's first key are never loaded.  No wgmma or TMA
// yet.
//
// Layout: 256 threads; thread t owns key row r = t / 4 of the tile and,
// with its 3 neighbours, the q-tile's 64 query columns (c = t % 4 + 4 * j)
// and the row's D dk/dv columns (d = t % 4 + 4 * i).  Shared tiles are f32
// with a padded row stride (D + 1).

#include <math.h>

#include "attention_common.cuh"

namespace {

using namespace flash;

template <typename T, bool DROPOUT>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int Sq, int Sk, int D, int num_heads,
                 int causal, float scale, int q_offset, int k_offset,
                 uint32_t seed, uint32_t drop_threshold, float drop_scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  const int ldp = BQ + 1;
  float* sK = smem;                    // [BK][ld]
  float* sV = sK + BK * ld;            // [BK][ld]
  float* sQ = sV + BK * ld;            // [BQ][ld]
  float* sdO = sQ + BQ * ld;           // [BQ][ld]
  float* sP = sdO + BQ * ld;           // [BK][BQ + 1]: dropped P, transposed
  float* sS = sP + BK * ldp;           // [BK][BQ + 1]: dS, transposed
  float* sL = sS + BK * ldp;           // [BQ]: lse (dead rows: +1e30)
  float* sDl = sL + BQ;                // [BQ]: delta

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int r = tid / TPR;             // key row within the tile
  const int sub = tid % TPR;
  const int kj = k0 + r;
  const long long qbase = (long long)bh * Sq * D;
  const long long kbase = (long long)bh * Sk * D;
  const float bias_j =
      (bias && kj < Sk) ? bias[(long long)(bh / num_heads) * Sk + kj] : 0.f;

  load_tiles(sK, sV, k + kbase, v + kbase, k0, Sk, D);

  // queries that can see this tile at all: under causal, global query
  // position q_offset + i >= k_offset + (first key of the tile)
  int q_begin = 0;
  if (causal) q_begin = max(0, k_offset + k0 - q_offset) / BQ * BQ;

  float acc_k[ND], acc_v[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc_k[i] = acc_v[i] = 0.f;

  for (int qt = q_begin; qt < Sq; qt += BQ) {
    __syncthreads();                   // previous tile fully consumed
    load_tiles(sQ, sdO, q + qbase, dout + qbase, qt, Sq, D);
    for (int idx = tid; idx < BQ; idx += THREADS) {
      const int gi = qt + idx;
      const float l = gi < Sq ? lse[(long long)bh * Sq + gi] : -INFINITY;
      sL[idx] = isfinite(l) ? l : -NEG_INF;
      sDl[idx] = gi < Sq ? delta[(long long)bh * Sq + gi] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = sub + TPR * j;
      const int gi = qt + c;
      float p_used = 0.f, ds = 0.f;
      if (gi < Sq && kj < Sk) {
        float dot = 0.f, dp = 0.f;
        for (int d = 0; d < D; ++d) {
          dot = fmaf(sQ[c * ld + d], sK[r * ld + d], dot);
          dp = fmaf(sdO[c * ld + d], sV[r * ld + d], dp);
        }
        float sv = dot * scale + bias_j;
        if (causal && q_offset + gi < k_offset + kj) sv = NEG_INF;
        const float p = expf(sv - sL[c]);
        p_used = p;
        if (DROPOUT) {
          const bool keep = dropout_keep(seed, bh, gi, kj, drop_threshold);
          p_used = keep ? p * drop_scale : 0.f;
          dp = keep ? dp * drop_scale : 0.f;
        }
        ds = p * (dp - sDl[c]);
      }
      sP[r * ldp + c] = p_used;
      sS[r * ldp + c] = ds;
    }
    __syncwarp();                      // the row's 4 threads share a warp
    const int qn = min(BQ, Sq - qt);
    for (int c = 0; c < qn; ++c) {
      const float pu = sP[r * ldp + c], ds = sS[r * ldp + c];
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        const int d = sub + TPR * i;
        if (d < D) {
          acc_v[i] = fmaf(pu, sdO[c * ld + d], acc_v[i]);
          acc_k[i] = fmaf(ds, sQ[c * ld + d], acc_k[i]);
        }
      }
    }
  }

  if (kj < Sk) {
    const long long obase = kbase + (long long)kj * D;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      const int d = sub + TPR * i;
      if (d < D) {
        store(dk + obase + d, acc_k[i] * scale);
        store(dv + obase + d, acc_v[i]);
      }
    }
  }
}

template <typename T, bool DROPOUT>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* dout, const void* lse, const void* delta, void* dk,
           void* dv, int BH, int Sq, int Sk, int D, int num_heads,
           int causal, float scale, int q_offset, int k_offset, int seed,
           int drop_threshold, float drop_scale, cudaStream_t stream) {
  size_t smem = sizeof(float) * ((size_t)(2 * BK + 2 * BQ) * (D + 1) +
                                 (size_t)2 * BK * (BQ + 1) + 2 * BQ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_kernel<T, DROPOUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sk + BK - 1) / BK, BH);
  flash_dkv_kernel<T, DROPOUT><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)bias,
      (const T*)dout, (const float*)lse, (const float*)delta, (T*)dk, (T*)dv,
      Sq, Sk, D, num_heads, causal, scale, q_offset, k_offset,
      (uint32_t)seed, (uint32_t)drop_threshold, drop_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// seed and drop_threshold are 32-bit words passed as ints; drop_scale is
// 1 / (1 - rate), or 0 for no dropout.
extern "C" int flash_attention_dkv(const void* q, const void* k,
                                   const void* v, const void* bias,
                                   const void* dout, const void* lse,
                                   const void* delta, void* dk, void* dv,
                                   int BH, int Sq, int Sk, int D,
                                   int num_heads, int causal, float scale,
                                   int q_offset, int k_offset, int is_bf16,
                                   int seed, int drop_threshold,
                                   float drop_scale, void* stream) {
  if (D < 1 || D > MAX_D) return (int)cudaErrorInvalidValue;
  auto fn = is_bf16 ? (drop_scale > 0.f ? launch<__nv_bfloat16, true>
                                        : launch<__nv_bfloat16, false>)
                    : (drop_scale > 0.f ? launch<float, true>
                                        : launch<float, false>);
  return fn(q, k, v, bias, dout, lse, delta, dk, dv, BH, Sq, Sk, D,
            num_heads, causal, scale, q_offset, k_offset, seed,
            drop_threshold, drop_scale, (cudaStream_t)stream);
}
