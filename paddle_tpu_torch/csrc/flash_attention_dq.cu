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
// q (f32 or bf16); bias, lse, delta f32; all sums f32.  The dropout mask is
// attention_common.cuh's, the forward kernel's own, evaluated once per
// (query, key) pair whose P is not 0.
//
// What bounds it on the H100: operations.  6 * D FLOPs per visible
// (query, key) pair (the score, dP and the dQ product) against one read of
// q, k, v, do and one write of dq: at BERT's [BH = 384, S = 128, D = 64]
// about 16 FLOP per f32 byte, growing with S, at or above the card's
// 20 FLOP/byte f32 ridge.  f32 runs on the CUDA cores (67 TFLOP/s, plain
// f32 FMAs, no TF32); bf16 on the tensor cores.  Dropout adds one
// Philox4x32-10 (about 60 integer instructions) per pair.
//
// What the design does about it.  A block owns 64 query rows and their dq
// rows (no atomics, no second pass: bit-identical from run to run) and
// walks the keys in 64-row tiles; P and dS never leave the SM.  K and V
// tiles stream through shared memory by cp.async, K double-buffered and V
// reloaded as soon as dP has read it, so the next tile's copies overlap
// this tile's products.  Under causal, the walk stops at the diagonal.  The
// head dim is a compile-time DP of 64 or 128: a smaller D is zero-padded
// up to it as the tiles load.
//
// * f32 route: 256 threads as 16 row groups x 16 column groups, as in the
//   forward.  S = Q K^T and dP = dO V^T are register-tiled: thread (ty, tx)
//   owns rows ty*4 + i and keys tx + 16j, reading Q, dO, K and V as they lie
//   ([row][d], rows padded by 16 bytes) four d at a time as float4s (64
//   FMAs for 8 shared loads).  dS goes to shared memory transposed
//   ([key][row], written and read back by the row group's own half-warp)
//   and dQ += dS K reads one float4 of dS and DP/64 float4s of K for every
//   16 * DP/64 FMAs.
// * bf16 route (FlashAttention-2 style): 4 warps, each owning 16 query rows
//   with Q's and dO's fragments held in registers for the whole key loop.
//   S and dP by mma.sync.m16n8k16 (K and V via ldmatrix); dS computed on the
//   f32 fragments, cast to bf16 where the reference casts it
//   (ds.astype(k.dtype)) and used from registers as the A operand of
//   dQ += dS K (K via ldmatrix.trans).  f32 accumulation throughout.  wgmma
//   and TMA are later work.

#include "attention_common.cuh"

namespace {

using namespace flash;
using namespace sm90;

constexpr int BQ = 64;     // query rows a block
constexpr int BKV = 64;    // key rows a tile

// keys the block's rows can see at all: under causal, global key position
// k_offset + j <= q_offset + (last row of the block)
__device__ __forceinline__ int key_end(const BwdArgs& a, int q0) {
  if (!a.causal) return a.Sk;
  const int last_q = min(q0 + BQ, a.Sq) - 1;
  return max(0, min(a.Sk, a.q_offset + last_q - a.k_offset + 1));
}

// ------------------------------------------------------------ f32 route
constexpr int F32_THREADS = 256;

template <int DP>
struct F32Dq {
  static constexpr int LD = DP + 4;            // floats, +16 bytes a row
  static constexpr int LDS = BQ + 4;
  // Q, dO, K x 2, V, dS^T
  static constexpr int SMEM = 4 * ((2 * BQ + 3 * BKV) * LD + BKV * LDS);
};

template <int DP, bool DROPOUT>
__global__ void __launch_bounds__(F32_THREADS, DP == 64 ? 2 : 1)
flash_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             float* __restrict__ dq, BwdArgs a) {
  using F = F32Dq<DP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);     // [BQ][LD]
  float* sdO = sQ + BQ * F::LD;                       // [BQ][LD]
  float* sK = sdO + BQ * F::LD;                       // [2][BKV][LD]
  float* sV = sK + 2 * BKV * F::LD;                   // [BKV][LD]
  float* sS = sV + BKV * F::LD;                       // [BKV][LDS], dS^T

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int D = a.D;
  const long long qbase = (long long)bh * a.Sq * D;
  const long long kbase = (long long)bh * a.Sk * D;
  const float* brow =
      a.bias ? a.bias + (long long)(bh / a.num_heads) * a.Sk : nullptr;
  const int ntiles = (key_end(a, q0) + BKV - 1) / BKV;

  load_rows<float, DP, F::LD, F32_THREADS>(sQ, q + qbase, q0, a.Sq, D);
  load_rows<float, DP, F::LD, F32_THREADS>(sdO, dout + qbase, q0, a.Sq, D);
  if (ntiles > 0) {
    load_rows<float, DP, F::LD, F32_THREADS>(sK, k + kbase, 0, a.Sk, D);
    load_rows<float, DP, F::LD, F32_THREADS>(sV, v + kbase, 0, a.Sk, D);
  }
  cp_commit();

  float lse_r[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    const bool in = qi < a.Sq;
    const long long r = (long long)bh * a.Sq + (in ? qi : 0);
    lse_r[i] = lse_of(a.lse[r], in);
    dl[i] = in ? a.delta[r] : 0.f;
  }
  float acc[4][DP / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int d = 0; d < DP / 16; ++d) acc[i][d] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_wait<0>();                      // K(t), V(t) (and Q, dO) landed ...
    __syncthreads();                   // ... for all; tile t-1 consumed
    const int kt = t * BKV;
    if (t + 1 < ntiles)
      load_rows<float, DP, F::LD, F32_THREADS>(
          sK + ((t + 1) % 2) * BKV * F::LD, k + kbase, kt + BKV, a.Sk, D);
    cp_commit();
    const float* tK = sK + (t % 2) * BKV * F::LD;

    float s[4][4], dp[4][4];
    dot_patch<DP, F::LD>(s, sQ, tK, ty, tx);       // S = Q K^T
    dot_patch<DP, F::LD>(dp, sdO, sV, ty, tx);     // dP = dO V^T
    __syncthreads();                   // every read of V(t) done
    if (t + 1 < ntiles)
      load_rows<float, DP, F::LD, F32_THREADS>(sV, v + kbase, kt + BKV,
                                               a.Sk, D);
    cp_commit();

    // dS = P (dP - delta), into s
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kj = kt + tx + 16 * j;
      const float bk = brow && kj < a.Sk ? brow[kj] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = q0 + ty * 4 + i;
        float p_used, d = dp[i][j];
        const float p = bwd_p<DROPOUT>(a, score(a, s[i][j], bk, qi, kj),
                                       lse_r[i], bh, qi, kj, &d, &p_used);
        s[i][j] = p * (d - dl[i]);
      }
    }
    store_patch_t<F::LDS>(sS, s, ty, tx);
    __syncwarp();
    acc_patch<DP, F::LD, F::LDS>(acc, sS, tK, ty, tx);   // dQ += dS K
  }
  cp_wait<0>();                        // nothing in flight at exit
  store_acc_f32<DP>(dq + qbase, acc, q0, a.Sq, D, a.scale, ty, tx);
}

// ------------------------------------------------------------ bf16 route
constexpr int BF_THREADS = 128;

template <int DP>
struct BfDq {
  static constexpr int LD = DP + 8;            // bf16s, +16 bytes a row
  // Q, dO, K x 2, V x 2
  static constexpr int SMEM = 2 * (2 * BQ + 4 * BKV) * LD;
};

template <int DP, bool DROPOUT>
__global__ void __launch_bounds__(BF_THREADS)
flash_dq_bf16(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const __nv_bfloat16* __restrict__ dout,
              __nv_bfloat16* __restrict__ dq, BwdArgs a) {
  using F = BfDq<DP>;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);       // [BQ][LD]
  bf16* sdO = sQ + BQ * F::LD;                        // [BQ][LD]
  bf16* sK = sdO + BQ * F::LD;                        // [2][BKV][LD]
  bf16* sV = sK + 2 * BKV * F::LD;                    // [2][BKV][LD]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int D = a.D;
  const long long qbase = (long long)bh * a.Sq * D;
  const long long kbase = (long long)bh * a.Sk * D;
  const float* brow =
      a.bias ? a.bias + (long long)(bh / a.num_heads) * a.Sk : nullptr;
  const int ntiles = (key_end(a, q0) + BKV - 1) / BKV;
  // this lane's two rows (h = 0, 1) of the warp's 16
  int qrow[2];
  qrow[0] = q0 + warp * 16 + lane / 4;
  qrow[1] = qrow[0] + 8;

  load_rows<bf16, DP, F::LD, BF_THREADS>(sQ, q + qbase, q0, a.Sq, D);
  load_rows<bf16, DP, F::LD, BF_THREADS>(sdO, dout + qbase, q0, a.Sq, D);
  if (ntiles > 0) {
    load_rows<bf16, DP, F::LD, BF_THREADS>(sK, k + kbase, 0, a.Sk, D);
    load_rows<bf16, DP, F::LD, BF_THREADS>(sV, v + kbase, 0, a.Sk, D);
  }
  cp_commit();

  float lse_r[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = qrow[h] < a.Sq;
    const long long r = (long long)bh * a.Sq + (in ? qrow[h] : 0);
    lse_r[h] = lse_of(a.lse[r], in);
    dl[h] = in ? a.delta[r] : 0.f;
  }
  uint32_t qf[DP / 16][4], of[DP / 16][4];
  float acc[DP / 8][4];
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_wait<0>();
    __syncthreads();
    const int kt = t * BKV;
    if (t == 0) {
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {
        const int off = (warp * 16 + lane % 16) * F::LD + ks * 16 +
                        (lane / 16) * 8;
        ldmatrix_x4(qf[ks], sQ + off);
        ldmatrix_x4(of[ks], sdO + off);
      }
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

    // S = Q K^T and dP = dO V^T: 8 tiles of 16 x 8 across the 64 keys
    float s[BKV / 8][4], dp[BKV / 8][4];
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks)
#pragma unroll
      for (int nt = 0; nt < BKV / 8; nt += 2) {
        const int off = (nt * 8 + lane % 8 + (lane / 16) * 8) * F::LD +
                        ks * 16 + ((lane / 8) % 2) * 8;
        uint32_t r[4];
        ldmatrix_x4(r, tK + off);
        const uint32_t k0[2] = {r[0], r[1]}, k1[2] = {r[2], r[3]};
        mma_bf16(s[nt], qf[ks], k0);
        mma_bf16(s[nt + 1], qf[ks], k1);
        ldmatrix_x4(r, tV + off);
        const uint32_t v0[2] = {r[0], r[1]}, v1[2] = {r[2], r[3]};
        mma_bf16(dp[nt], of[ks], v0);
        mma_bf16(dp[nt + 1], of[ks], v1);
      }

    // dS = P (dP - delta) on the fragments, into s
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = kt + nt * 8 + (lane % 4) * 2 + e;
        const float bk = brow && kj < a.Sk ? brow[kj] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float p_used, d = dp[nt][2 * h + e];
          const float p = bwd_p<DROPOUT>(
              a, score(a, s[nt][2 * h + e], bk, qrow[h], kj), lse_r[h], bh,
              qrow[h], kj, &d, &p_used);
          s[nt][2 * h + e] = p * (d - dl[h]);
        }
      }

    // dQ += dS K: dS's fragments of keys 16kk .. 16kk+15, cast to bf16,
    // are the A operand
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t sa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nt = 0; nt < DP / 8; nt += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(
            r, tK + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * F::LD +
                   nt * 8 + (lane / 16) * 8);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_bf16(acc[nt], sa, b0);
        mma_bf16(acc[nt + 1], sa, b1);
      }
    }
  }
  cp_wait<0>();                        // nothing in flight at exit
  store_acc_bf16<DP>(dq + qbase, acc, qrow, a.Sq, D, a.scale, lane);
}

// ------------------------------------------------------------ launch
template <typename T>
int run(void (*kernel)(const T*, const T*, const T*, const T*, T*, BwdArgs),
        int threads, int smem, const void* q, const void* k, const void* v,
        const void* dout, void* dq, const BwdArgs& a, int BH,
        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sq + BQ - 1) / BQ, BH);
  kernel<<<grid, threads, smem, stream>>>((const T*)q, (const T*)k,
                                          (const T*)v, (const T*)dout,
                                          (T*)dq, a);
  return (int)cudaGetLastError();
}

template <int DP>
int launch(const void* q, const void* k, const void* v, const void* dout,
           void* dq, const BwdArgs& a, int BH, int is_bf16, cudaStream_t s) {
  const bool drop = a.drop_scale > 0.f;
  if (is_bf16)
    return run<__nv_bfloat16>(drop ? flash_dq_bf16<DP, true>
                                   : flash_dq_bf16<DP, false>,
                              BF_THREADS, BfDq<DP>::SMEM, q, k, v, dout, dq,
                              a, BH, s);
  return run<float>(drop ? flash_dq_f32<DP, true> : flash_dq_f32<DP, false>,
                    F32_THREADS, F32Dq<DP>::SMEM, q, k, v, dout, dq, a, BH,
                    s);
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
  if (D < 8 || D > 128 || D % 8 || BH < 1 || Sq < 1 || Sk < 1)
    return (int)cudaErrorInvalidValue;
  BwdArgs a{(const float*)bias, (const float*)lse, (const float*)delta,
            Sq, Sk, D, num_heads, causal, scale, q_offset,
            k_offset, (uint32_t)seed, (uint32_t)drop_threshold, drop_scale};
  cudaStream_t s = (cudaStream_t)stream;
  return D <= 64 ? launch<64>(q, k, v, dout, dq, a, BH, is_bf16, s)
                 : launch<128>(q, k, v, dout, dq, a, BH, is_bf16, s);
}
