// Paged decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces: paddle_tpu/kernels/decode_attention.py:_decode_kernel
// (launched by flash_attention_decode).
//
// Computes, per b*h and query row i < q_len (1 <= q_len <= 8):
//   L    = lengths[bh / num_heads]           (keys visible to row 0)
//   s_ij = scale * q_i . k_j   for j < min(L + i, S_max)
//   o_i  = sum_j softmax_j(s_i) v_j, and o_i = 0 where row i sees no key.
// q [BH, q_len, D]; caches [BH, S_max, D]; o [BH, q_len, D] (f32 or bf16,
// the type of q); lengths [B] int32.  f32 online softmax and accumulator.
//
// What bounds it on the H100: bytes.  A decode step does 4 * D FLOPs per
// visible key and row against 2 * D * sizeof(T) bytes of cache per key: at
// q_len 1 that is 1 FLOP/byte (f32), far below the ridge, so the floor is
// the K/V rows the lengths make visible, read once, over 3.35 TB/s.
//
// What the design does about it: the block walks its sequence's cache
// only up to min(S_max, L + q_len - 1) keys, not the whole S_max the TPU
// kernel walks and masks, so the bytes read follow the real lengths.  Each
// K/V tile (64 keys) is read from device memory once into shared memory
// and serves every query row of the chunk.  Query rows are taken directly
// (no padding of the chunk to 8 rows).  One block per b*h: at GPT-2 small
// with 8 slots that is 96 blocks for 132 SMs; a split-K pass over the
// cache is a later change.
//
// Layout: 256 threads = 8 warps; warp w owns query row w.  In a tile, lane
// l scores keys l and l + 32; the row's max and sum are warp shuffles; for
// the product with V, lane l owns output columns l + 32 * i.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int MAX_ROWS = 8;
constexpr int MAX_D = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, const int* __restrict__ lengths,
              T* __restrict__ o, int q_len, int S, int D, int num_heads,
              float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* sQ = smem;                    // [MAX_ROWS][ld]
  float* sK = sQ + MAX_ROWS * ld;      // [BK][ld]
  float* sV = sK + BK * ld;            // [BK][ld]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x;
  const int L = lengths[bh / num_heads];
  const long long qbase = (long long)bh * q_len * D;
  const long long cbase = (long long)bh * S * D;

  for (int idx = tid; idx < q_len * D; idx += THREADS)
    sQ[(idx / D) * ld + idx % D] = to_f32(q[qbase + idx]);

  // the last visible key of the last row is L + q_len - 2
  const int k_end = max(0, min(S, L + q_len - 1));
  const int row = warp;
  const bool active = row < q_len;
  const int visible = min(S, L + row);  // keys row `row` may see

  constexpr int ND = MAX_D / 32;
  float acc[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = 0.f;
  float m_run = NEG_INF, l_run = 0.f;

  for (int kt = 0; kt < k_end; kt += BK) {
    __syncthreads();
    const int kn = min(BK, k_end - kt);
    for (int idx = tid; idx < kn * D; idx += THREADS) {
      int rr = idx / D, cc = idx % D;
      long long g = cbase + (long long)(kt + rr) * D + cc;
      sK[rr * ld + cc] = to_f32(kc[g]);
      sV[rr * ld + cc] = to_f32(vc[g]);
    }
    __syncthreads();
    if (!active) continue;

    float s[2];
    float m_tile = NEG_INF;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      int c = lane + 32 * jj;
      float sv = NEG_INF;
      if (c < kn && kt + c < visible) {
        float dot = 0.f;
        for (int d = 0; d < D; ++d)
          dot = fmaf(sQ[row * ld + d], sK[c * ld + d], dot);
        sv = dot * scale;
      }
      s[jj] = sv;
      m_tile = fmaxf(m_tile, sv);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, off));
    float m_new = fmaxf(m_run, m_tile);
    float m_safe = m_new > NEG_INF * 0.5f ? m_new : 0.f;
    float corr = expf(m_run - m_safe);
    float p[2], psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      p[jj] = s[jj] > NEG_INF * 0.5f ? expf(s[jj] - m_safe) : 0.f;
      psum += p[jj];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l_run = corr * l_run + psum;
    m_run = m_new;
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] *= corr;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      // keys 32*jj .. of the tile: lane c holds their probabilities
      const int cn = min(32, kn - 32 * jj);
      for (int c = 0; c < cn; ++c) {
        float pc = __shfl_sync(0xffffffffu, p[jj], c);
        const float* vrow = sV + (32 * jj + c) * ld;
#pragma unroll
        for (int i = 0; i < ND; ++i) {
          int d = lane + 32 * i;
          if (d < D) acc[i] = fmaf(pc, vrow[d], acc[i]);
        }
      }
    }
  }

  if (active) {
    float inv = l_run > 0.f ? 1.f / l_run : 0.f;
    long long obase = qbase + (long long)row * D;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      int d = lane + 32 * i;
      if (d < D) store(o + obase + d, acc[i] * inv);
    }
  }
}

template <typename T>
int launch(const void* q, const void* kc, const void* vc,
           const void* lengths, void* o, int BH, int q_len, int S, int D,
           int num_heads, float scale, cudaStream_t stream) {
  size_t smem = sizeof(float) * (size_t)(MAX_ROWS + 2 * BK) * (D + 1);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_kernel<T><<<BH, THREADS, smem, stream>>>(
      (const T*)q, (const T*)kc, (const T*)vc, (const int*)lengths, (T*)o,
      q_len, S, D, num_heads, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int decode_attention(const void* q, const void* k_cache,
                                const void* v_cache, const void* lengths,
                                void* o, int BH, int q_len, int S, int D,
                                int num_heads, float scale, int is_bf16,
                                void* stream) {
  if (q_len < 1 || q_len > MAX_ROWS || D < 1 || D > MAX_D)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k_cache, v_cache, lengths, o, BH, q_len,
                                 S, D, num_heads, scale, s);
  return launch<float>(q, k_cache, v_cache, lengths, o, BH, q_len, S, D,
                       num_heads, scale, s);
}
