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
// f32; all sums f32.  The dropout mask is attention_common.cuh's, evaluated
// once per (query, key) pair whose P is not 0.
//
// What bounds it on the H100: operations.  8 * D FLOPs per visible
// (query, key) pair (the score, dP, dV and dK products) against one read
// of q, k, v, do and one write of dk and dv: about 18 FLOP per f32 byte
// at BERT's S = 128, growing with S, near the card's 20 FLOP/byte f32
// ridge.  f32 runs on the CUDA cores (67 TFLOP/s, plain f32 FMAs, no
// TF32); bf16 on the tensor cores.  Dropout adds one Philox4x32-10 per
// pair.
//
// What the design does about it.  A block owns 64 key rows and their dk
// and dv rows (no atomics: bit-identical from run to run), keeps K and V in
// shared memory and walks the queries in 64-row tiles; P and dS never leave
// the SM.  Q and dO tiles, with their lse and delta rows, stream through
// shared memory by cp.async, so the next tile's copies overlap this tile's
// products.  Under causal, the walk starts at the q-tile holding the first
// query that sees the block's first key.  The head dim is a compile-time
// DP of 64 or 128: a smaller D is zero-padded up to it as the tiles load.
//
// * f32 route: 256 threads as 16 row groups x 16 column groups.  The
//   block computes the transposed tiles S^T = K Q^T and dP^T = V dO^T,
//   register-tiled: thread (ty, tx) owns keys ty*4 + i and queries
//   tx + 16j, reading K, V, Q and dO as they lie ([row][d], rows padded by
//   16 bytes) four d at a time as float4s.  P_dropped^T, then dS^T, go to
//   one shared [query][key] buffer (each row group's half-warp writes and
//   reads back only its own four keys), and dV += P_dropped^T dO and
//   dK += dS^T Q read one float4 of it and DP/64 float4s of dO or Q for
//   every 16 * DP/64 FMAs.  Q is double-buffered; dO is reloaded as soon as
//   dV has read it, so its copy overlaps the dK product and the next
//   tile's S^T.
// * bf16 route (FlashAttention-2 style): 4 warps, each owning 16 keys.
//   S^T = K Q^T and dP^T = V dO^T by mma.sync.m16n8k16 (K and V the A
//   operand via ldmatrix, Q and dO the B operand via ldmatrix); P^T and
//   dS^T on the f32 fragments, cast to bf16 where the reference casts them
//   (p_used.astype(do.dtype), ds.astype(q.dtype)), stay in registers as
//   the A operand of dV += P_dropped^T dO and dK += dS^T Q (dO and Q via
//   ldmatrix.trans).  lse and delta are read per query column from shared
//   memory.  At DP = 128 the q-tile is taken in two halves of 32 queries,
//   which keeps S^T and dP^T within the register file beside the two
//   accumulators.  wgmma and TMA are later work.

#include "attention_common.cuh"

namespace {

using namespace flash;
using namespace sm90;

constexpr int BQ = 64;     // query rows a tile
constexpr int BKV = 64;    // key rows a block

// the first q-tile whose queries can see key k0: under causal, global query
// position q_offset + i >= k_offset + k0
__device__ __forceinline__ int first_q_tile(const BwdArgs& a, int k0) {
  return a.causal ? max(0, a.k_offset + k0 - a.q_offset) / BQ : 0;
}

// Copy the lse and delta entries of query rows [row0, row0 + 64) into sL
// and sD (zeros past Sq) with 4-byte cp.async: a row's offset bh * Sq + i
// need not be 16-byte aligned.
__device__ __forceinline__ void load_row_terms(float* sL, float* sD,
                                               const BwdArgs& a, int bh,
                                               int row0) {
  const int i = threadIdx.x % BQ;
  if (threadIdx.x >= 2 * BQ) return;
  const bool in = row0 + i < a.Sq;
  const long long r = (long long)bh * a.Sq + (in ? row0 + i : 0);
  if (threadIdx.x < BQ)
    cp_async4(sL + i, a.lse + r, in);
  else
    cp_async4(sD + i, a.delta + r, in);
}

// ------------------------------------------------------------ f32 route
constexpr int F32_THREADS = 256;

template <int DP>
struct F32Dkv {
  static constexpr int LD = DP + 4;            // floats, +16 bytes a row
  static constexpr int LDS = BKV + 4;
  // K, V, Q x 2, dO, P^T / dS^T, lse and delta x 2
  static constexpr int SMEM =
      4 * ((2 * BKV + 3 * BQ) * LD + BQ * LDS + 4 * BQ);
};

template <int DP, bool DROPOUT>
__global__ void __launch_bounds__(F32_THREADS, DP == 64 ? 2 : 1)
flash_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              float* __restrict__ dk, float* __restrict__ dv, BwdArgs a) {
  using F = F32Dkv<DP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);     // [BKV][LD]
  float* sV = sK + BKV * F::LD;                       // [BKV][LD]
  float* sQ = sV + BKV * F::LD;                       // [2][BQ][LD]
  float* sdO = sQ + 2 * BQ * F::LD;                   // [BQ][LD]
  float* sP = sdO + BQ * F::LD;                       // [BQ][LDS]
  float* sL = sP + BQ * F::LDS;                       // [2][BQ] lse
  float* sD = sL + 2 * BQ;                            // [2][BQ] delta

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y, k0 = blockIdx.x * BKV;
  const int D = a.D;
  const long long qbase = (long long)bh * a.Sq * D;
  const long long kbase = (long long)bh * a.Sk * D;
  const int t0 = first_q_tile(a, k0);
  const int nt = (a.Sq + BQ - 1) / BQ;

  load_rows<float, DP, F::LD, F32_THREADS>(sK, k + kbase, k0, a.Sk, D);
  load_rows<float, DP, F::LD, F32_THREADS>(sV, v + kbase, k0, a.Sk, D);
  if (t0 < nt) {
    load_rows<float, DP, F::LD, F32_THREADS>(sQ, q + qbase, t0 * BQ, a.Sq,
                                             D);
    load_rows<float, DP, F::LD, F32_THREADS>(sdO, dout + qbase, t0 * BQ,
                                             a.Sq, D);
    load_row_terms(sL, sD, a, bh, t0 * BQ);
  }
  cp_commit();

  float bk[4];                         // the bias of this thread's keys
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty * 4 + i;
    bk[i] = a.bias && kj < a.Sk
                ? a.bias[(long long)(bh / a.num_heads) * a.Sk + kj]
                : 0.f;
  }
  float acc_k[4][DP / 16], acc_v[4][DP / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int d = 0; d < DP / 16; ++d) acc_k[i][d] = acc_v[i][d] = 0.f;

  for (int t = t0; t < nt; ++t) {
    cp_wait<0>();                      // Q(t), dO(t), rows(t) landed ...
    __syncthreads();                   // ... for all; tile t-1 consumed
    const int qt = t * BQ, cur = (t - t0) % 2, nb = cur ^ 1;
    if (t + 1 < nt) {
      load_rows<float, DP, F::LD, F32_THREADS>(sQ + nb * BQ * F::LD,
                                               q + qbase, qt + BQ, a.Sq, D);
      load_row_terms(sL + nb * BQ, sD + nb * BQ, a, bh, qt + BQ);
    }
    cp_commit();
    const float* tQ = sQ + cur * BQ * F::LD;
    const float* tL = sL + cur * BQ;
    const float* tD = sD + cur * BQ;

    float s[4][4], dp[4][4];
    dot_patch<DP, F::LD>(s, sK, tQ, ty, tx);       // S^T = K Q^T
    dot_patch<DP, F::LD>(dp, sV, sdO, ty, tx);     // dP^T = V dO^T

    // P_dropped^T into s, dS^T into dp
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j, qi = qt + c;
      const float lse = lse_of(tL[c], qi < a.Sq), dl = tD[c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kj = k0 + ty * 4 + i;
        float p_used, d = dp[i][j];
        const float p = bwd_p<DROPOUT>(a, score(a, s[i][j], bk[i], qi, kj),
                                       lse, bh, qi, kj, &d, &p_used);
        s[i][j] = p_used;
        dp[i][j] = p * (d - dl);
      }
    }
    store_patch_t<F::LDS>(sP, s, ty, tx);
    __syncwarp();
    acc_patch<DP, F::LD, F::LDS>(acc_v, sP, sdO, ty, tx);  // dV += P^T dO
    __syncthreads();                   // every read of dO(t) done
    if (t + 1 < nt)
      load_rows<float, DP, F::LD, F32_THREADS>(sdO, dout + qbase, qt + BQ,
                                               a.Sq, D);
    cp_commit();
    store_patch_t<F::LDS>(sP, dp, ty, tx);
    __syncwarp();
    acc_patch<DP, F::LD, F::LDS>(acc_k, sP, tQ, ty, tx);   // dK += dS^T Q
  }
  cp_wait<0>();                        // nothing in flight at exit
  store_acc_f32<DP>(dk + kbase, acc_k, k0, a.Sk, D, a.scale, ty, tx);
  store_acc_f32<DP>(dv + kbase, acc_v, k0, a.Sk, D, 1.f, ty, tx);
}

// ------------------------------------------------------------ bf16 route
constexpr int BF_THREADS = 128;

template <int DP>
struct BfDkv {
  static constexpr int LD = DP + 8;            // bf16s, +16 bytes a row
  static constexpr int QC = DP == 64 ? 64 : 32;   // queries a pass
  // K, V, Q x 2, dO x 2 (bf16); lse and delta x 2 (f32)
  static constexpr int SMEM = 2 * (2 * BKV + 4 * BQ) * LD + 4 * 4 * BQ;
};

template <int DP, bool DROPOUT>
__global__ void __launch_bounds__(BF_THREADS)
flash_dkv_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const __nv_bfloat16* __restrict__ dout,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
               BwdArgs a) {
  using F = BfDkv<DP>;
  using bf16 = __nv_bfloat16;
  constexpr int QC = F::QC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);       // [BKV][LD]
  bf16* sV = sK + BKV * F::LD;                        // [BKV][LD]
  bf16* sQ = sV + BKV * F::LD;                        // [2][BQ][LD]
  bf16* sdO = sQ + 2 * BQ * F::LD;                    // [2][BQ][LD]
  float* sL = reinterpret_cast<float*>(sdO + 2 * BQ * F::LD);  // [2][BQ]
  float* sD = sL + 2 * BQ;                            // [2][BQ]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, k0 = blockIdx.x * BKV;
  const int D = a.D;
  const long long qbase = (long long)bh * a.Sq * D;
  const long long kbase = (long long)bh * a.Sk * D;
  const int t0 = first_q_tile(a, k0);
  const int nt = (a.Sq + BQ - 1) / BQ;
  // this lane's two keys (h = 0, 1) of the warp's 16
  int krow[2];
  krow[0] = k0 + warp * 16 + lane / 4;
  krow[1] = krow[0] + 8;

  load_rows<bf16, DP, F::LD, BF_THREADS>(sK, k + kbase, k0, a.Sk, D);
  load_rows<bf16, DP, F::LD, BF_THREADS>(sV, v + kbase, k0, a.Sk, D);
  if (t0 < nt) {
    load_rows<bf16, DP, F::LD, BF_THREADS>(sQ, q + qbase, t0 * BQ, a.Sq, D);
    load_rows<bf16, DP, F::LD, BF_THREADS>(sdO, dout + qbase, t0 * BQ, a.Sq,
                                           D);
    load_row_terms(sL, sD, a, bh, t0 * BQ);
  }
  cp_commit();

  float bk[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    bk[h] = a.bias && krow[h] < a.Sk
                ? a.bias[(long long)(bh / a.num_heads) * a.Sk + krow[h]]
                : 0.f;
  float acc_k[DP / 8][4], acc_v[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  // A-operand rows of the warp's 16 keys in K and V
  const int a_off = (warp * 16 + lane % 16) * F::LD + (lane / 16) * 8;

  for (int t = t0; t < nt; ++t) {
    cp_wait<0>();
    __syncthreads();
    const int qt = t * BQ, cur = (t - t0) % 2, nb = cur ^ 1;
    if (t + 1 < nt) {
      load_rows<bf16, DP, F::LD, BF_THREADS>(sQ + nb * BQ * F::LD,
                                             q + qbase, qt + BQ, a.Sq, D);
      load_rows<bf16, DP, F::LD, BF_THREADS>(sdO + nb * BQ * F::LD,
                                             dout + qbase, qt + BQ, a.Sq, D);
      load_row_terms(sL + nb * BQ, sD + nb * BQ, a, bh, qt + BQ);
    }
    cp_commit();
    const bf16* tQ = sQ + cur * BQ * F::LD;
    const bf16* tdO = sdO + cur * BQ * F::LD;
    const float* tL = sL + cur * BQ;
    const float* tD = sD + cur * BQ;

#pragma unroll
    for (int qc = 0; qc < BQ; qc += QC) {
      // S^T = K Q^T and dP^T = V dO^T: QC/8 tiles of 16 x 8 across the
      // pass's queries
      float s[QC / 8][4], dp[QC / 8][4];
#pragma unroll
      for (int n = 0; n < QC / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {
        uint32_t ka[4], va[4];
        ldmatrix_x4(ka, sK + a_off + ks * 16);
        ldmatrix_x4(va, sV + a_off + ks * 16);
#pragma unroll
        for (int n = 0; n < QC / 8; n += 2) {
          const int off =
              (qc + n * 8 + lane % 8 + (lane / 16) * 8) * F::LD + ks * 16 +
              ((lane / 8) % 2) * 8;
          uint32_t r[4];
          ldmatrix_x4(r, tQ + off);
          const uint32_t q0f[2] = {r[0], r[1]}, q1f[2] = {r[2], r[3]};
          mma_bf16(s[n], ka, q0f);
          mma_bf16(s[n + 1], ka, q1f);
          ldmatrix_x4(r, tdO + off);
          const uint32_t o0f[2] = {r[0], r[1]}, o1f[2] = {r[2], r[3]};
          mma_bf16(dp[n], va, o0f);
          mma_bf16(dp[n + 1], va, o1f);
        }
      }

      // P_dropped^T into s, dS^T into dp; fragment element e is key
      // krow[e / 2], query column qc + n*8 + (lane%4)*2 + e%2
#pragma unroll
      for (int n = 0; n < QC / 8; ++n)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int c = qc + n * 8 + (lane % 4) * 2 + e2, qi = qt + c;
          const float lse = lse_of(tL[c], qi < a.Sq), dl = tD[c];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 2 * h + e2;
            float p_used, d = dp[n][e];
            const float p = bwd_p<DROPOUT>(
                a, score(a, s[n][e], bk[h], qi, krow[h]), lse, bh, qi,
                krow[h], &d, &p_used);
            s[n][e] = p_used;
            dp[n][e] = p * (d - dl);
          }
        }

      // dV += P_dropped^T dO and dK += dS^T Q: the bf16 fragments of
      // queries qc + 16kk .. +15 are the A operands
#pragma unroll
      for (int kk = 0; kk < QC / 16; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const uint32_t sa[4] = {
            pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
            pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
            pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
            pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
        const int row =
            (qc + kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * F::LD +
            (lane / 16) * 8;
#pragma unroll
        for (int n = 0; n < DP / 8; n += 2) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, tdO + row + n * 8);
          const uint32_t o0f[2] = {r[0], r[1]}, o1f[2] = {r[2], r[3]};
          mma_bf16(acc_v[n], pa, o0f);
          mma_bf16(acc_v[n + 1], pa, o1f);
          ldmatrix_x4_trans(r, tQ + row + n * 8);
          const uint32_t q0f[2] = {r[0], r[1]}, q1f[2] = {r[2], r[3]};
          mma_bf16(acc_k[n], sa, q0f);
          mma_bf16(acc_k[n + 1], sa, q1f);
        }
      }
    }
  }
  cp_wait<0>();                        // nothing in flight at exit
  store_acc_bf16<DP>(dk + kbase, acc_k, krow, a.Sk, D, a.scale, lane);
  store_acc_bf16<DP>(dv + kbase, acc_v, krow, a.Sk, D, 1.f, lane);
}

// ------------------------------------------------------------ launch
template <typename T>
int run(void (*kernel)(const T*, const T*, const T*, const T*, T*, T*,
                       BwdArgs),
        int threads, int smem, const void* q, const void* k, const void* v,
        const void* dout, void* dk, void* dv, const BwdArgs& a, int BH,
        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sk + BKV - 1) / BKV, BH);
  kernel<<<grid, threads, smem, stream>>>((const T*)q, (const T*)k,
                                          (const T*)v, (const T*)dout,
                                          (T*)dk, (T*)dv, a);
  return (int)cudaGetLastError();
}

template <int DP>
int launch(const void* q, const void* k, const void* v, const void* dout,
           void* dk, void* dv, const BwdArgs& a, int BH, int is_bf16,
           cudaStream_t s) {
  const bool drop = a.drop_scale > 0.f;
  if (is_bf16)
    return run<__nv_bfloat16>(drop ? flash_dkv_bf16<DP, true>
                                   : flash_dkv_bf16<DP, false>,
                              BF_THREADS, BfDkv<DP>::SMEM, q, k, v, dout, dk,
                              dv, a, BH, s);
  return run<float>(drop ? flash_dkv_f32<DP, true>
                         : flash_dkv_f32<DP, false>,
                    F32_THREADS, F32Dkv<DP>::SMEM, q, k, v, dout, dk, dv, a,
                    BH, s);
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
  if (D < 8 || D > 128 || D % 8 || BH < 1 || Sq < 1 || Sk < 1)
    return (int)cudaErrorInvalidValue;
  BwdArgs a{(const float*)bias, (const float*)lse, (const float*)delta,
            Sq, Sk, D, num_heads, causal, scale, q_offset,
            k_offset, (uint32_t)seed, (uint32_t)drop_threshold, drop_scale};
  cudaStream_t s = (cudaStream_t)stream;
  return D <= 64 ? launch<64>(q, k, v, dout, dk, dv, a, BH, is_bf16, s)
                 : launch<128>(q, k, v, dout, dk, dv, a, BH, is_bf16, s);
}
