// Fused GEMM + epilogue for Hopper (sm_90a), plain C interface.
//
// Replaces: paddle_tpu/kernels/fused_gemm.py:_kernel (launched by
// fused_gemm).
//
// Computes out[M, N] = epilogue(x[M, K] @ y[K, N]) with an f32 accumulator,
// the epilogue in f32 on the accumulator registers, in the order the fusion
// pass matched it in the program:
//   v = acc (+ bias[n]) -> relu | gelu (erf or tanh) (+ residual[m, n])
//   -> row-wise layer_norm (two-pass: mean, then mean((v - mean)^2);
//      (v - mean) / sqrt(var + eps), * ln_scale[n], + ln_bias[n])
//   -> one cast to the output type.
// x and y are both f32 or both bf16; bias, residual and the layer_norm
// parameters arrive as f32; out is f32 or bf16.
//
// What bounds it on the H100: operations.  2*M*N*K FLOPs against
// (M*K + K*N + M*N) * elt bytes: at BERT-base's shapes (K = 768 or 3072)
// hundreds of FLOPs per byte, far above the ridge.  f32 runs on the CUDA
// cores (67 TFLOP/s: plain f32 FMAs, never TF32, as precision='highest'
// asks); bf16 runs on the tensor cores (989 TFLOP/s dense).
//
// What the design does about it.  Both routes share one block tile,
// 256 threads, and one mainloop shape: a ring of k-tiles in dynamic shared
// memory fed by cp.async, so the next tiles arrive while the current one is
// multiplied, with one __syncthreads a k-tile.  The tile is one of four
// compiled tilings (kernels/fused_gemm.py COMPILED_BLOCKS, the autotuner's
// candidates): 128 x 256 outputs (DEFAULT_BLOCKS), 128 x 128, 64 x 128 and
// 64 x 64, k in 32-deep tiles on the f32 route and 64-deep on the bf16
// route.  The larger tiles reuse each loaded element more; the smaller ones
// give a small GEMM more blocks on the 132 SMs (ResNet-50's fc head,
// [128, 2048] @ [2048, 1000], is 4 blocks of 128 x 256 and 32 of 64 x 64).
// Each tiling is the same templates instantiated with other constants
// (struct Tiling below).
//
// * f32 route: a SIMT register-tiled GEMM, TM x TN accumulators a thread
//   (8 x 16 at the default tile: 128 FMAs for every 6 16-byte shared
//   loads), 3 stages.  x reaches the
//   k-major layout the FMA loop reads as float4s by 4-byte cp.async copies
//   that transpose it on the way (k-rows padded so the stores do not
//   collide); y's [k][n] tile is copied as it lies, 16 bytes at a time,
//   and read as float4s of 16 neighbouring columns.  Each output
//   element is one FMA chain over k = 0 .. K-1 in order, the order of
//   cuBLAS's SIMT SGEMM, so the unfused chain on cuBLAS and this kernel
//   round the same way where cuBLAS does not split k (the fusion witness
//   relies on that at m = 16384, K = 3072).  At small M (M <= 64, no
//   layer_norm) cuBLAS splits k, and one chain over all of K ends 4-5x
//   farther from the exact product than it (K = 768 .. 3072,
//   tools/torch_k5_small_m_check.py); there the route splits k too: the
//   tiling's mainloop runs over up to 64 k ranges of whole k-tiles, each
//   block's chain into a workspace slice, and a second pass adds the
//   slices pairwise in a fixed tree (deterministic) before the epilogue.
//   A small-M grid also has few blocks (4 of 128 x 256 at [8, 1000]), so
//   the splits fill the card.
// * bf16 route: mma.sync.m16n8k16 bf16 x bf16 -> f32 on the tensor cores;
//   8 warps of MT x NT mma tiles (at the default tile 64 x 64: 4 x 8 mma
//   tiles, 128 f32 accumulators a thread),
//   k in 64-deep tiles (half the barriers of 32), 3 stages, x and y copied
//   16 bytes at a time (8 where N or K is not a multiple of 8); x via
//   ldmatrix, y via ldmatrix.trans from its [k][n] rows
//   (row strides padded by 16 bytes, so the eight rows of each 8 x 8
//   matrix fall in distinct banks).  The epilogue runs on the f32
//   fragments.  wgmma and TMA are later work.
//
// The epilogue runs on the f32 accumulators and the tile is stored once:
// the unfused chain's intermediates (GEMM output, bias sum, activation)
// never reach device memory.  The accumulators are staged in shared memory
// first and the epilogue walks them row by row (see store_tile).
// Blocks walk N fastest (blockIdx.x is the column tile, so M is at most
// 65535 row tiles): the blocks in flight share their x rows through L2.
// Ragged M, N and K are masked in the kernel
// (cp.async zero-fills what lies outside); N and K must be multiples of 4,
// so every copied chunk (16 bytes of f32, 8 of bf16) lies wholly inside or
// wholly outside a row.
//
// The layer_norm variants need whole rows, and keep their own tiles under
// every tiling: a block owns 32 rows, walks N in
// column tiles with the same mainloops (f32: 32 x 256 tiles, 4 x 8
// accumulators a thread, 8-deep k-tiles in 4 stages; bf16: 32 x 128 tiles,
// 8 warps of 16 x 32, 3 stages), parks each tile's f32 accumulators in
// dynamic shared memory behind the ring (32 * N * 4 bytes: N <= 1524 fits
// beside the larger ring, 37,376 bytes, in 227 KB), and after the last tile
// each warp runs its rows through the epilogue, normalises and stores them.

#include <math.h>

#include "mma_common.cuh"

namespace {

constexpr int ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_GELU_TANH = 3;
constexpr int THREADS = 256;

constexpr int F32_STAGES = 3, BF_STAGES = 3;
// the layer_norm variants: LN_BM whole rows a block
constexpr int LN_BM = 32;
constexpr int LN_F32_BN = 256, LN_F32_BK = 8, LN_F32_TM = 4, LN_F32_TN = 8,
              LN_F32_STAGES = 4;
constexpr int LN_BF_BN = 128, LN_BF_BK = 32, LN_BF_MT = 1, LN_BF_NT = 4,
              LN_BF_STAGES = 3;
constexpr int MAX_SMEM = 232448;   // bytes one block may use on the H100
// k splits of the small-M f32 route at most (kernels/fused_gemm.py
// MAX_SPLITS)
constexpr int MAX_SPLITS = 64;

struct Epilogue {
  const float* bias;      // [N] or null
  const float* residual;  // [M, N] or null
  const float* ln_scale;  // [N] or null
  const float* ln_bias;   // [N] or null
  void* out;              // [M, N]: f32, or bf16 with out_bf16
  int act, out_bf16;
  float eps;
};

using namespace sm90;

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// out[i] in the output type (a run-time choice: the stores are outside
// the mainloop, and one kernel per output type would double the build)
__device__ __forceinline__ void store_out1(const Epilogue& ep, long long i,
                                           float v) {
  if (ep.out_bf16) ((__nv_bfloat16*)ep.out)[i] = __float2bfloat16(v);
  else ((float*)ep.out)[i] = v;
}

// PyTorch's own gelu formulas (ATen's GeluCUDAKernelImpl), so the fused
// chain and torch.nn.functional.gelu on the unfused chain agree
__device__ __forceinline__ float activate(float v, int act) {
  if (act == ACT_RELU) return fmaxf(v, 0.f);
  if (act == ACT_GELU)
    return v * 0.5f * (1.f + erff(v * 0.70710678118654752440f));
  if (act == ACT_GELU_TANH) {
    const float kBeta = 0.79788456080286535588f;   // sqrt(2 / pi)
    const float kKappa = 0.044715f;
    float inner = kBeta * (v + kKappa * (v * v * v));
    return 0.5f * v * (1.f + tanhf(inner));
  }
  return v;
}

// bias[c], or 0 past N or without a bias
__device__ __forceinline__ float bias_at(const Epilogue& ep, int c, int N) {
  return ep.bias && c < N ? __ldg(ep.bias + c) : 0.f;
}

// bias -> activation -> residual, the epilogue before any layer_norm; b is
// bias_at(ep, c, N)
__device__ __forceinline__ float pre_norm(float v, float b, long long r,
                                          int c, int N, const Epilogue& ep) {
  if (ep.bias) v += b;
  v = activate(v, ep.act);
  if (ep.residual) v += __ldg(ep.residual + r * N + c);
  return v;
}

// ------------------------------------------------------------ f32 route
// One block tile of TBM x TBN outputs; thread (ty, tx) owns rows
// g * (TBM*4/TM) + ty*4 + i and columns g * (TBN*4/TN) + tx*4 + j: groups
// of 4 spread over the tile, so each warp's y reads are float4s of
// neighbouring columns and its stores are coalesced.
template <int TBM, int TBN, int TBK, int TM, int TN, int STAGES>
struct F32Tile {
  static constexpr int TX = TBN / TN;
  static constexpr int LDA = TBM + 4;     // As[k][m]: +16 bytes a k-row
  static constexpr int STAGE = TBK * LDA + TBK * TBN;     // floats
  static constexpr int SMEM = STAGES * STAGE * 4;         // bytes
  static_assert((TBM / TM) * (TBN / TN) == THREADS, "one output a slot");
  static_assert(TM % 4 == 0 && TN % 4 == 0 && TBK % 8 == 0, "float4s");
  static_assert(TBM * TBK % THREADS == 0 && TBK * TBN / 4 % THREADS == 0,
                "whole copy rounds");

  __device__ static int row(int i, int ty) {
    return (i / 4) * (TBM * 4 / TM) + ty * 4 + i % 4;
  }
  __device__ static int col(int j, int tx) {
    return (j / 4) * (TBN * 4 / TN) + tx * 4 + j % 4;
  }

  // x rows [m0, m0+TBM) x k [k0, k0+TBK), transposed into As[k][m] by
  // 4-byte copies: a warp reads 8 neighbouring k of 4 rows (4 whole
  // sectors) and, with the k-rows padded by 4 floats, writes 32 distinct
  // banks.  y's k rows x n columns [n0, n0+TBN) as Bs[k][n], 16 bytes a
  // copy.
  // (K is x's row stride; k at or past ke is zero-filled)
  __device__ static void load(const float* __restrict__ x,
                              const float* __restrict__ y, int M, int N,
                              int K, int ke, int m0, int n0, int k0,
                              float* st) {
    float* As = st;
    float* Bs = st + TBK * LDA;
#pragma unroll
    for (int it = 0; it < TBM * TBK / THREADS; ++it) {
      const int idx = threadIdx.x + it * THREADS;
      const int c = (idx / (8 * TBM)) * 8 + idx % 8, r = (idx / 8) % TBM;
      const int gm = m0 + r, gk = k0 + c;
      const bool in = gm < M && gk < ke;
      cp_async4(As + c * LDA + r, in ? x + (long long)gm * K + gk : x, in);
    }
#pragma unroll
    for (int it = 0; it < TBK * TBN / 4 / THREADS; ++it) {
      const int idx = threadIdx.x + it * THREADS;
      const int r = idx / (TBN / 4), c = (idx % (TBN / 4)) * 4;
      const int gk = k0 + r, gn = n0 + c;
      const bool in = gk < ke && gn < N;
      cp_async16(Bs + r * TBN + c, in ? y + (long long)gk * N + gn : y, in);
    }
  }

  // per k: TM/4 float4s of x (2 distinct addresses a warp: broadcasts)
  // and TN/4 of y (16 neighbouring columns a warp), TM * TN FMAs
  __device__ static void compute(const float* st, float acc[TM][TN]) {
    const float* As = st;
    const float* Bs = st + TBK * LDA;
    const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll
    for (int kk = 0; kk < TBK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) {
        const float4 t =
            *reinterpret_cast<const float4*>(As + kk * LDA + row(4 * g, ty));
        a[4 * g] = t.x; a[4 * g + 1] = t.y;
        a[4 * g + 2] = t.z; a[4 * g + 3] = t.w;
      }
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const float4 t =
            *reinterpret_cast<const float4*>(Bs + kk * TBN + col(4 * g, tx));
        b[4 * g] = t.x; b[4 * g + 1] = t.y;
        b[4 * g + 2] = t.z; b[4 * g + 3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  // acc = x[m0:, kb:ke] @ y[kb:ke, n0:], k in order (ke < 0: K); the
  // ring is free on return
  __device__ static void mainloop(const float* __restrict__ x,
                                  const float* __restrict__ y, int M, int N,
                                  int K, int m0, int n0, float* ring,
                                  float acc[TM][TN], int kb = 0,
                                  int ke = -1) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    if (ke < 0) ke = K;
    const int nk = (ke - kb + TBK - 1) / TBK;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk)
        load(x, y, M, N, K, ke, m0, n0, kb + s * TBK, ring + s * STAGE);
      cp_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_wait<STAGES - 2>();    // k-tile kt has landed
      __syncthreads();          // ... for every thread; kt-1 is consumed
      const int nxt = kt + STAGES - 1;
      if (nxt < nk)
        load(x, y, M, N, K, ke, m0, n0, kb + nxt * TBK,
             ring + (nxt % STAGES) * STAGE);
      cp_commit();
      compute(ring + (kt % STAGES) * STAGE, acc);
    }
    cp_wait<0>();
    __syncthreads();
  }
};

using F32Ln = F32Tile<LN_BM, LN_F32_BN, LN_F32_BK, LN_F32_TM, LN_F32_TN,
                      LN_F32_STAGES>;

// ------------------------------------------------------------ bf16 route
// One block tile of TBM x TBN outputs, TBK-deep k-tiles; warp (wm, wn) owns
// MT x NT mma tiles of 16 x 8 at rows wm*MT*16 and columns wn*NT*8.
// Accumulator e of tile (mt, nt) is row mt*16 + lane/4 + 8*(e/2), column
// nt*8 + (lane%4)*2 + e%2 of the warp's patch.
template <int TBM, int TBN, int TBK, int MT, int NT, int STAGES>
struct BfTile {
  static constexpr int WN = TBN / (8 * NT);
  static constexpr int LDA = TBK + 8;     // bf16s; +16 bytes a row
  static constexpr int LDB = TBN + 8;
  static constexpr int STAGE = TBM * LDA + TBK * LDB;     // bf16s
  static constexpr int SMEM = STAGES * STAGE * 2;         // bytes
  static_assert((TBM / (16 * MT)) * WN == THREADS / 32, "8 warps");
  static_assert(NT % 2 == 0, "B fragments come in pairs");
  static_assert(TBK % 16 == 0, "k16 mma steps");
  static_assert(TBM * TBK % (4 * THREADS) == 0 &&
                    TBK * TBN % (4 * THREADS) == 0,
                "whole copy rounds of 4-element chunks");

  // chunks of 8 bf16 (16-byte copies) when N and K are multiples of 8,
  // else of 4 (8 bytes): the contract asks only multiples of 4
  template <bool WIDE>
  __device__ static void load(const __nv_bfloat16* __restrict__ x,
                              const __nv_bfloat16* __restrict__ y, int M,
                              int N, int K, int m0, int n0, int k0,
                              __nv_bfloat16* st) {
    constexpr int PER = WIDE ? 8 : 4;
    __nv_bfloat16* As = st;
    __nv_bfloat16* Bs = st + TBM * LDA;
#pragma unroll
    for (int it = 0; it < TBM * TBK / PER / THREADS; ++it) {
      const int idx = threadIdx.x + it * THREADS;
      const int r = idx / (TBK / PER), c = (idx % (TBK / PER)) * PER;
      const int gm = m0 + r, gk = k0 + c;
      const bool in = gm < M && gk < K;
      const __nv_bfloat16* src = in ? x + (long long)gm * K + gk : x;
      if (WIDE) cp_async16(As + r * LDA + c, src, in);
      else cp_async8(As + r * LDA + c, src, in);
    }
#pragma unroll
    for (int it = 0; it < TBK * TBN / PER / THREADS; ++it) {
      const int idx = threadIdx.x + it * THREADS;
      const int r = idx / (TBN / PER), c = (idx % (TBN / PER)) * PER;
      const int gk = k0 + r, gn = n0 + c;
      const bool in = gk < K && gn < N;
      const __nv_bfloat16* src = in ? y + (long long)gk * N + gn : y;
      if (WIDE) cp_async16(Bs + r * LDB + c, src, in);
      else cp_async8(Bs + r * LDB + c, src, in);
    }
  }

  __device__ static void compute(const __nv_bfloat16* st,
                                 float acc[MT][NT][4]) {
    const __nv_bfloat16* As = st;
    const __nv_bfloat16* Bs = st + TBM * LDA;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp / WN, wn = warp % WN;
#pragma unroll
    for (int ks = 0; ks < TBK; ks += 16) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(a[mt], As + (wm * MT * 16 + mt * 16 + lane % 16) * LDA +
                               ks + (lane / 16) * 8);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, Bs + (ks + lane % 8 + ((lane / 8) % 2) * 8) *
                                      LDB +
                                 wn * NT * 8 + nt * 8 + (lane / 16) * 8);
        b[nt][0] = r[0]; b[nt][1] = r[1];
        b[nt + 1][0] = r[2]; b[nt + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
    }
  }

  template <bool WIDE>
  __device__ static void mainloop(const __nv_bfloat16* __restrict__ x,
                                  const __nv_bfloat16* __restrict__ y, int M,
                                  int N, int K, int m0, int n0,
                                  __nv_bfloat16* ring, float acc[MT][NT][4]) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    const int nk = (K + TBK - 1) / TBK;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk)
        load<WIDE>(x, y, M, N, K, m0, n0, s * TBK, ring + s * STAGE);
      cp_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_wait<STAGES - 2>();
      __syncthreads();
      const int nxt = kt + STAGES - 1;
      if (nxt < nk)
        load<WIDE>(x, y, M, N, K, m0, n0, nxt * TBK,
                   ring + (nxt % STAGES) * STAGE);
      cp_commit();
      compute(ring + (kt % STAGES) * STAGE, acc);
    }
    cp_wait<0>();
    __syncthreads();
  }

  // (row, column) of accumulator pair h (elements 2h, 2h+1) of tile
  // (mt, nt), relative to the block tile
  __device__ static int row(int mt, int h) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    return (warp / WN) * MT * 16 + mt * 16 + lane / 4 + 8 * h;
  }
  __device__ static int col(int nt) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    return (warp % WN) * NT * 8 + nt * 8 + (lane % 4) * 2;
  }
};

using BfLn = BfTile<LN_BM, LN_BF_BN, LN_BF_BK, LN_BF_MT, LN_BF_NT,
                    LN_BF_STAGES>;

// bytes of the larger layer_norm ring, ahead of the parked rows
constexpr int LN_RING = F32Ln::SMEM > BfLn::SMEM ? F32Ln::SMEM : BfLn::SMEM;
static_assert(LN_RING == 37376, "kernels/fused_gemm.py _LN_RING_SMEM");

// One compiled tiling of the main (non-layer_norm) kernels: BM x BN
// outputs a block, BK-deep f32 k-tiles (2*BK on the bf16 route), TM x TN
// f32 accumulators a thread, MT x NT bf16 mma tiles a warp.
template <int BM_, int BN_, int BK_, int TM_, int TN_, int MT_, int NT_>
struct Tiling {
  static constexpr int BM = BM_, BN = BN_, BK = BK_;
  static constexpr int TM = TM_, TN = TN_, MT = MT_, NT = NT_;
  using F32 = F32Tile<BM, BN, BK, TM, TN, F32_STAGES>;
  using Bf = BfTile<BM, BN, 2 * BK, MT, NT, BF_STAGES>;
  static constexpr int LDT = BN + 4;              // staged tile row stride
  static constexpr int TILE_SMEM = BM * LDT * 4;  // bytes
  static constexpr int F32_SMEM =
      F32::SMEM > TILE_SMEM ? F32::SMEM : TILE_SMEM;
  static constexpr int BF_SMEM = Bf::SMEM > TILE_SMEM ? Bf::SMEM : TILE_SMEM;
  static_assert(F32_SMEM <= MAX_SMEM && BF_SMEM <= MAX_SMEM, "fits");
};

// kernels/fused_gemm.py COMPILED_BLOCKS, in that order
using T128x256 = Tiling<128, 256, 32, 8, 16, 4, 8>;   // DEFAULT_BLOCKS
using T128x128 = Tiling<128, 128, 32, 8, 8, 4, 4>;
using T64x128 = Tiling<64, 128, 32, 4, 8, 2, 4>;
using T64x64 = Tiling<64, 64, 32, 4, 4, 2, 2>;

// the split route's tiling under each triple: its M (at most
// kernels/fused_gemm.py SPLITK_MAX_M, 64) fits one 64-row tile, where a
// 128-row tile computes at least 64 empty rows a block (on the H100,
// 0.0238 against 0.0189 device ms at the ResNet-50 fc head with 64
// splits; tools/torch_k5_small_m_check.py --chains)
template <typename T> struct SplitTiling { using type = T64x128; };
template <> struct SplitTiling<T64x64> { using type = T64x64; };

// ------------------------------------------------------------ epilogue
// The main kernels stage their f32 accumulators in shared memory (the ring
// is free by then) and run the epilogue as a loop over rows, four
// neighbouring columns a thread a pass, unrolled 4 times: the activation's
// code is inlined 16 times, not once per accumulator (fully unrolled over 128
// accumulators, erff alone made the epilogue cost more than the GEMM), and
// the bias and residual loads and the stores are coalesced.  With one
// block an SM nothing hides the epilogue, so its per-pass work shows in
// the kernel's time: each thread reads its columns' bias once, and the
// loop is specialised on the activation and output type.
// rows rl0, rl0 + THREADS*4/BN, ... of a thread's four columns c .. c+3
// (bias b): specialised on the activation and the output type, so the
// loop body branches on nothing but the row bound and a residual
template <typename T, int ACT, bool BF16_OUT>
__device__ __forceinline__ void store_cols(const float* tile,
                                           const Epilogue& ep, int M, int N,
                                           int m0, int cl, int c,
                                           const float b[4]) {
#pragma unroll 4
  for (int rl = threadIdx.x * 4 / T::BN; rl < T::BM;
       rl += THREADS * 4 / T::BN) {
    const int r = m0 + rl;
    if (r >= M) break;
    const float4 t =
        *reinterpret_cast<const float4*>(tile + rl * T::LDT + cl);
    float v[4] = {t.x, t.y, t.z, t.w};
    const long long i = (long long)r * N + c;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (ep.bias) v[j] += b[j];
      v[j] = activate(v[j], ACT);
      if (ep.residual) v[j] += __ldg(ep.residual + i + j);
    }
    if (BF16_OUT)
      *reinterpret_cast<uint2*>((__nv_bfloat16*)ep.out + i) =
          make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
    else
      store4((float*)ep.out + i, v);
  }
}

template <typename T, int ACT>
__device__ __forceinline__ void store_cols(const float* tile,
                                           const Epilogue& ep, int M, int N,
                                           int m0, int cl, int c,
                                           const float b[4]) {
  if (ep.out_bf16) store_cols<T, ACT, true>(tile, ep, M, N, m0, cl, c, b);
  else store_cols<T, ACT, false>(tile, ep, M, N, m0, cl, c, b);
}

// The staged tile through the epilogue to out.  A thread keeps its four
// columns for the whole tile (THREADS * 4 is a multiple of BN), so it
// reads their bias once.
template <typename T>
__device__ __forceinline__ void store_tile(const float* tile,
                                           const Epilogue& ep, int M, int N,
                                           int m0, int n0) {
  static_assert(THREADS * 4 % T::BN == 0, "a thread's columns stay put");
  const int cl = threadIdx.x * 4 % T::BN, c = n0 + cl;
  if (c >= N) return;                          // N % 4 == 0: four or none
  float b[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) b[j] = bias_at(ep, c + j, N);
  switch (ep.act) {
    case ACT_RELU:
      store_cols<T, ACT_RELU>(tile, ep, M, N, m0, cl, c, b);
      break;
    case ACT_GELU:
      store_cols<T, ACT_GELU>(tile, ep, M, N, m0, cl, c, b);
      break;
    case ACT_GELU_TANH:
      store_cols<T, ACT_GELU_TANH>(tile, ep, M, N, m0, cl, c, b);
      break;
    default: store_cols<T, ACT_NONE>(tile, ep, M, N, m0, cl, c, b);
  }
}

// each warp takes rows of the block's LN_BM parked GEMM rows through the
// epilogue (bias, activation, residual: in place, summing for the mean),
// then normalises them two-pass and stores them
__device__ __forceinline__ void layer_norm_rows(float* rows,
                                                const Epilogue& ep, int M,
                                                int N, int m0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float inv_n = 1.f / (float)N;
  for (int rl = warp; rl < LN_BM; rl += THREADS / 32) {
    const long long r = m0 + rl;
    if (r >= M) break;
    float* row = rows + rl * N;
    float s = 0.f;
    for (int c = lane; c < N; c += 32) {
      const float v = pre_norm(row[c], bias_at(ep, c, N), r, c, N, ep);
      row[c] = v;
      s += v;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    const float mean = s * inv_n;
    float q = 0.f;
    for (int c = lane; c < N; c += 32) {
      const float d = row[c] - mean;
      q = fmaf(d, d, q);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      q += __shfl_xor_sync(0xffffffffu, q, off);
    const float denom = sqrtf(q * inv_n + ep.eps);
    for (int c = lane; c < N; c += 32) {
      float v = (row[c] - mean) / denom;
      if (ep.ln_scale) v *= ep.ln_scale[c];
      if (ep.ln_bias) v += ep.ln_bias[c];
      store_out1(ep, r * N + c, v);
    }
  }
}

// ------------------------------------------------------------ kernels
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ y,
                Epilogue ep, int M, int N, int K) {
  using F = typename T::F32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  float acc[T::TM][T::TN];
  F::mainloop(x, y, M, N, K, m0, n0, smem, acc);
  const int tx = threadIdx.x % F::TX, ty = threadIdx.x / F::TX;
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int g = 0; g < T::TN / 4; ++g)
      store4(smem + F::row(i, ty) * T::LDT + F::col(4 * g, tx),
             &acc[i][4 * g]);
  __syncthreads();
  store_tile<T>(smem, ep, M, N, m0, n0);
}

// small M on the f32 route (see fused_gemm below): split z of the k
// range, [z*ks, min(K, (z+1)*ks)), through the tiling's mainloop into its
// own [M, N] slice of the f32 workspace
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
gemm_f32_splitk_kernel(const float* __restrict__ x,
                       const float* __restrict__ y, float* __restrict__ ws,
                       int M, int N, int K, int ks) {
  using F = typename T::F32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int kb = blockIdx.z * ks, ke = min(K, kb + ks);
  float acc[T::TM][T::TN];
  F::mainloop(x, y, M, N, K, m0, n0, reinterpret_cast<float*>(smem_raw),
              acc, kb, ke);
  const int tx = threadIdx.x % F::TX, ty = threadIdx.x / F::TX;
  float* part = ws + (long long)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int r = m0 + F::row(i, ty);
    if (r >= M) continue;
#pragma unroll
    for (int g = 0; g < T::TN / 4; ++g) {
      const int c = n0 + F::col(4 * g, tx);
      if (c < N) store4(part + (long long)r * N + c, &acc[i][4 * g]);
    }
  }
}

// the splits' partial sums of each output added pairwise in a fixed tree
// (split z + w into z, w = 1, 2, 4, ...), then the epilogue; one thread
// an output
__global__ void __launch_bounds__(THREADS)
splitk_reduce_kernel(const float* __restrict__ ws, Epilogue ep, int M,
                     int N, int splits) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long MN = (long long)M * N;
  if (i >= MN) return;
  float v[MAX_SPLITS];
  for (int z = 0; z < splits; ++z) v[z] = ws[z * MN + i];
  for (int w = 1; w < splits; w <<= 1)
    for (int z = 0; z + w < splits; z += 2 * w) v[z] += v[z + w];
  const int c = (int)(i % N);
  store_out1(ep, i, pre_norm(v[0], bias_at(ep, c, N), i / N, c, N, ep));
}

template <typename T, bool WIDE>
__global__ void __launch_bounds__(THREADS, 1)
gemm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ y, Epilogue ep, int M,
                 int N, int K) {
  using B = typename T::Bf;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  float acc[T::MT][T::NT][4];
  B::template mainloop<WIDE>(x, y, M, N, K, m0, n0,
                             reinterpret_cast<__nv_bfloat16*>(smem_raw),
                             acc);
  float* tile = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt)
        store2(tile + B::row(mt, h) * T::LDT + B::col(nt),
               acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
  __syncthreads();
  store_tile<T>(tile, ep, M, N, m0, n0);
}

__global__ void __launch_bounds__(THREADS, 1)
gemm_ln_f32_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   Epilogue ep, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  float* rows = reinterpret_cast<float*>(smem_raw + LN_RING);  // [LN_BM][N]
  const int m0 = blockIdx.x * LN_BM;
  const int tx = threadIdx.x % F32Ln::TX, ty = threadIdx.x / F32Ln::TX;
  for (int n0 = 0; n0 < N; n0 += LN_F32_BN) {
    float acc[LN_F32_TM][LN_F32_TN];
    F32Ln::mainloop(x, y, M, N, K, m0, n0, ring, acc);
#pragma unroll
    for (int i = 0; i < LN_F32_TM; ++i)
#pragma unroll
      for (int g = 0; g < LN_F32_TN / 4; ++g) {
        const int c = n0 + F32Ln::col(4 * g, tx);
        if (c < N) store4(rows + F32Ln::row(i, ty) * N + c, &acc[i][4 * g]);
      }
  }
  __syncthreads();
  layer_norm_rows(rows, ep, M, N, m0);
}

__global__ void __launch_bounds__(THREADS, 1)
gemm_ln_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ y, Epilogue ep, int M,
                    int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* rows = reinterpret_cast<float*>(smem_raw + LN_RING);  // [LN_BM][N]
  const int m0 = blockIdx.x * LN_BM;
  for (int n0 = 0; n0 < N; n0 += LN_BF_BN) {
    float acc[LN_BF_MT][LN_BF_NT][4];
    BfLn::mainloop<false>(x, y, M, N, K, m0, n0, ring, acc);
#pragma unroll
    for (int mt = 0; mt < LN_BF_MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < LN_BF_NT; ++nt) {
          const int c = n0 + BfLn::col(nt);
          if (c < N)
            store2(rows + BfLn::row(mt, h) * N + c, acc[mt][nt][2 * h],
                   acc[mt][nt][2 * h + 1]);
        }
  }
  __syncthreads();
  layer_norm_rows(rows, ep, M, N, m0);
}

// ------------------------------------------------------------ launch
template <typename Tin>
int run(void (*kernel)(const Tin*, const Tin*, Epilogue, int, int, int),
        dim3 grid, int smem, const void* x, const void* y,
        const Epilogue& ep, int M, int N, int K, cudaStream_t stream) {
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, stream>>>((const Tin*)x, (const Tin*)y, ep, M,
                                          N, K);
  return (int)cudaGetLastError();
}

// the main kernel of tiling T, its route picked by the input type and,
// on the bf16 route, by whether N and K allow 16-byte copies
template <typename T>
int run_main(const void* x, const void* y, const Epilogue& ep, int M, int N,
             int K, int in_bf16, cudaStream_t s) {
  if ((M + T::BM - 1) / T::BM > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM);
  if (in_bf16)
    return run(N % 8 || K % 8 ? gemm_bf16_kernel<T, false>
                              : gemm_bf16_kernel<T, true>,
               grid, T::BF_SMEM, x, y, ep, M, N, K, s);
  return run(gemm_f32_kernel<T>, grid, T::F32_SMEM, x, y, ep, M, N, K, s);
}

// the small-M f32 route: k in splits of ks (a multiple of the 32-deep
// k-tile) into ws, then one reduction + epilogue pass
template <typename T>
int run_splitk(const float* x, const float* y, float* ws, int splits,
               const Epilogue& ep, int M, int N, int K, cudaStream_t s) {
  const int ks = ((K + splits - 1) / splits + 31) / 32 * 32;
  const int used = (K + ks - 1) / ks;
  const dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM, used);
  const int smem = T::F32::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_f32_splitk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  gemm_f32_splitk_kernel<T><<<grid, THREADS, smem, s>>>(x, y, ws, M, N, K,
                                                         ks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long MN = (long long)M * N;
  splitk_reduce_kernel<<<(unsigned)((MN + THREADS - 1) / THREADS), THREADS,
                         0, s>>>(ws, ep, M, N, used);
  return (int)cudaGetLastError();
}

template <typename T>
int run_tiling(const void* x, const void* y, void* ws, int splits,
               const Epilogue& ep, int M, int N, int K, int in_bf16,
               cudaStream_t s) {
  if (splits > 1)
    return run_splitk<typename SplitTiling<T>::type>(
        (const float*)x, (const float*)y, (float*)ws, splits, ep, M, N, K,
        s);
  return run_main<T>(x, y, ep, M, N, K, in_bf16, s);
}

}  // namespace

// (block_m, block_n, block_k) names the tiling, one of
// kernels/fused_gemm.py COMPILED_BLOCKS; another triple returns
// cudaErrorInvalidValue.  The layer_norm variants keep their own 32-row
// tiles under every triple.  splits > 1 (f32 inputs, no layer_norm; the
// caller's rule, kernels/fused_gemm.py splitk_splits) runs a 64-row
// tiling's f32 mainloop (SplitTiling) over that many k ranges into
// workspace (splits * M * N floats) and adds them pairwise before the
// epilogue.
extern "C" int fused_gemm(const void* x, const void* y, const void* bias,
                          const void* residual, const void* ln_scale,
                          const void* ln_bias, void* out, int M, int N, int K,
                          int activation, int layer_norm, float ln_eps,
                          int in_bf16, int out_bf16, int block_m, int block_n,
                          int block_k, void* workspace, int splits,
                          void* stream) {
  if (M < 1 || N < 1 || K < 1 || N % 4 || K % 4 || activation < ACT_NONE ||
      activation > ACT_GELU_TANH || block_k != 32 || splits < 1 ||
      splits > MAX_SPLITS ||
      (splits > 1 && (layer_norm || in_bf16 || workspace == nullptr)))
    return (int)cudaErrorInvalidValue;
  Epilogue ep{(const float*)bias, (const float*)residual,
              (const float*)ln_scale, (const float*)ln_bias, out, activation,
              out_bf16, ln_eps};
  cudaStream_t s = (cudaStream_t)stream;
  if (layer_norm) {
    const dim3 ln_grid((M + LN_BM - 1) / LN_BM);
    const int ln_smem = LN_RING + (int)(sizeof(float) * LN_BM * (size_t)N);
    if (in_bf16)
      return run(gemm_ln_bf16_kernel, ln_grid, ln_smem, x, y, ep, M, N, K, s);
    return run(gemm_ln_f32_kernel, ln_grid, ln_smem, x, y, ep, M, N, K, s);
  }
  if (block_m == 128 && block_n == 256)
    return run_tiling<T128x256>(x, y, workspace, splits, ep, M, N, K,
                                in_bf16, s);
  if (block_m == 128 && block_n == 128)
    return run_tiling<T128x128>(x, y, workspace, splits, ep, M, N, K,
                                in_bf16, s);
  if (block_m == 64 && block_n == 128)
    return run_tiling<T64x128>(x, y, workspace, splits, ep, M, N, K,
                               in_bf16, s);
  if (block_m == 64 && block_n == 64)
    return run_tiling<T64x64>(x, y, workspace, splits, ep, M, N, K, in_bf16,
                              s);
  return (int)cudaErrorInvalidValue;
}
