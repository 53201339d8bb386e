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
// are f32 in both cases; f32 inputs use plain f32 FMAs (no TF32), as the
// reference asks precision='highest' for f32.
//
// What bounds it on the H100: operations.  At the main paths' shapes
// (serving prefill BH = 96, S = 128..512, D = 64, causal; BERT training
// BH = 384, S = 128, D = 64) the work is about 4 * D FLOPs per visible
// (query, key) pair against 4 * BH * S * D elements of q/k/v/o: far above
// the card's 20 FLOP/byte f32 ridge.  The f32 CUDA-core peak is
// 67 TFLOP/s.  Dropout adds one Philox4x32-10 (about 60 integer
// instructions) per visible pair.
//
// What the design does about it: scores never leave the SM (one 64x64
// tile in shared memory at a time, online softmax in registers), so
// device-memory traffic stays at one read of q/k/v per block and one
// write of o.  Under causal, k-tiles wholly above the diagonal are never
// loaded or computed: the loop stops at the last key the tile's last row
// can see, which halves the work at S = 512.  It does not use wgmma or
// TMA: those are for a later change that makes it fast.
//
// Layout: one block per (q-tile of 64 rows, bh); 256 threads; thread t
// owns query row r = t / 4 of the tile and, with its 3 neighbours, the
// row's 64 score columns (c = t % 4 + 4 * j) and its D output columns
// (d = t % 4 + 4 * i).  Shared tiles are f32 with a padded row stride
// (D + 1) so the column reads do not collide in the banks.

#include <math.h>

#include "attention_common.cuh"

namespace {

using namespace flash;

// DROPOUT is a template flag, so the kernel without dropout (the serving
// path's) carries no mask code at all.
template <typename T, bool DROPOUT>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 T* __restrict__ o, float* __restrict__ lse, int Sq, int Sk,
                 int D, int num_heads, int causal, float scale, int q_offset,
                 int k_offset, uint32_t seed, uint32_t drop_threshold,
                 float drop_scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* sQ = smem;                    // [BQ][ld]
  float* sK = sQ + BQ * ld;            // [BK][ld]
  float* sV = sK + BK * ld;            // [BK][ld]
  float* sP = sV + BK * ld;            // [BQ][BK + 1]
  const int ldp = BK + 1;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int r = tid / TPR;             // row within the tile
  const int sub = tid % TPR;
  const long long qbase = (long long)bh * Sq * D;
  const long long kbase = (long long)bh * Sk * D;
  const float* brow = bias ? bias + (long long)(bh / num_heads) * Sk : nullptr;

  load_tile(sQ, q + qbase, q0, Sq, D);

  // keys this tile can see at all: under causal, global key position
  // k_offset + j <= q_offset + (last row of the tile)
  int k_end = Sk;
  if (causal) {
    int last_q = min(q0 + BQ, Sq) - 1;
    int lim = q_offset + last_q - k_offset + 1;
    k_end = max(0, min(Sk, lim));
  }

  float acc[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = 0.f;
  float m_run = NEG_INF, l_run = 0.f;
  const int qi = q0 + r;               // this thread's global row

  for (int kt = 0; kt < k_end; kt += BK) {
    __syncthreads();                   // previous tile fully consumed
    load_tiles(sK, sV, k + kbase, v + kbase, kt, Sk, D);
    __syncthreads();

    float s[NC];
    float m_tile = NEG_INF;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      int c = sub + TPR * j;
      int gj = kt + c;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(sQ[r * ld + d], sK[c * ld + d], dot);
      float sv = dot * scale;
      if (brow) sv += gj < Sk ? brow[gj] : 0.f;
      if (causal && q_offset + qi < k_offset + gj) sv = NEG_INF;
      s[j] = sv;
      if (gj < Sk) m_tile = fmaxf(m_tile, sv);
    }
    // row max across the row's 4 threads (neighbouring lanes)
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 1));
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 2));
    float m_new = fmaxf(m_run, m_tile);
    float m_safe = m_new > NEG_INF * 0.5f ? m_new : 0.f;
    float corr = expf(m_run - m_safe);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      int c = sub + TPR * j;
      float p = (kt + c < Sk) ? expf(s[j] - m_safe) : 0.f;
      psum += p;                       // the normaliser sees every key
      if (DROPOUT)
        p = dropout_keep(seed, bh, qi, kt + c, drop_threshold)
                ? p * drop_scale : 0.f;
      sP[r * ldp + c] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_run = corr * l_run + psum;
    m_run = m_new;
    __syncwarp();                      // the row's 4 threads share a warp
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] *= corr;
    int kn = min(BK, k_end - kt);
    for (int c = 0; c < kn; ++c) {
      float p = sP[r * ldp + c];
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        int d = sub + TPR * i;
        if (d < D) acc[i] = fmaf(p, sV[c * ld + d], acc[i]);
      }
    }
  }

  if (qi < Sq) {
    long long obase = qbase + (long long)qi * D;
    float inv = l_run > 0.f ? 1.f / l_run : 0.f;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      int d = sub + TPR * i;
      if (d < D) store(o + obase + d, acc[i] * inv);
    }
    if (sub == 0)
      lse[(long long)bh * Sq + qi] =
          l_run > 0.f ? m_run + logf(l_run) : -INFINITY;
  }
}

template <typename T, bool DROPOUT>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* o, void* lse, int BH, int Sq, int Sk, int D, int num_heads,
           int causal, float scale, int q_offset, int k_offset, int seed,
           int drop_threshold, float drop_scale, cudaStream_t stream) {
  size_t smem = sizeof(float) * ((size_t)(BQ + 2 * BK) * (D + 1) +
                                 (size_t)BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DROPOUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, BH);
  flash_fwd_kernel<T, DROPOUT><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)bias, (T*)o,
      (float*)lse, Sq, Sk, D, num_heads, causal, scale, q_offset, k_offset,
      (uint32_t)seed, (uint32_t)drop_threshold, drop_scale);
  return (int)cudaGetLastError();
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
  if (D < 1 || D > MAX_D) return (int)cudaErrorInvalidValue;
  auto fn = is_bf16 ? (drop_scale > 0.f ? launch<__nv_bfloat16, true>
                                        : launch<__nv_bfloat16, false>)
                    : (drop_scale > 0.f ? launch<float, true>
                                        : launch<float, false>);
  return fn(q, k, v, bias, o, lse, BH, Sq, Sk, D, num_heads, causal, scale,
            q_offset, k_offset, seed, drop_threshold, drop_scale,
            (cudaStream_t)stream);
}
