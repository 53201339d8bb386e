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
// x and y are both f32 or both bf16 (converted to f32 on their way into
// shared memory); bias, residual and the layer_norm parameters arrive as
// f32; out is f32 or bf16.  f32 FMAs, never TF32 (precision='highest').
//
// What bounds it on the H100: operations.  2*M*N*K FLOPs against
// (M*K + K*N + M*N) * 4 bytes: at BERT-base's shapes (K = 768 or 3072)
// hundreds of FLOPs per byte, far above the ridge, so the floor is the
// f32 FMA rate of the CUDA cores (67 TFLOP/s).
//
// What the design does about it: a SIMT register-tiled GEMM.  A block owns
// a 128 x 128 output tile (256 threads, 8 x 8 accumulators each); k runs in
// 16-deep tiles through shared memory, each x and y element loaded from
// device memory once per tile as a 16-byte (f32) or 8-byte (bf16) vector.
// Each output element is one FMA chain over k = 0 .. K-1 in order, the
// order of a plain SIMT GEMM, so the unfused chain on cuBLAS and this
// kernel round the same way where cuBLAS does not split k.  The epilogue
// runs on the registers and the tile is stored once: the unfused chain's
// intermediates (GEMM output, bias sum, activation) never reach device
// memory.  Ragged M and N edges are masked in the kernel; K and N must be
// multiples of 4 (the vector loads).  wgmma, TMA and tensor cores for bf16
// are later work.
//
// The layer_norm variant needs whole rows: a block owns 32 rows, walks N in
// 128-column tiles (the same GEMM tile code, 4 x 4 accumulators a thread),
// parks each tile's pre-norm f32 values in dynamic shared memory
// (32 * N * 4 bytes: N <= 1736 fits beside the GEMM tiles in 227 KB), and
// after the last tile each warp normalises its rows and stores them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_GELU_TANH = 3;

// the plain GEMM's tile and the layer_norm variant's
constexpr int BM = 128, BN = 128, BK = 16, TM = 8, TN = 8;
constexpr int LN_BM = 32, LN_TM = 4, LN_TN = 4;
constexpr int THREADS = 256;

struct Epilogue {
  const float* bias;      // [N] or null
  const float* residual;  // [M, N] or null
  const float* ln_scale;  // [N] or null
  const float* ln_bias;   // [N] or null
  int act;
  float eps;
};

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  float2 a = __bfloat1622float2(q[0]), b = __bfloat1622float2(q[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v[0], v[1]);
  q[1] = __floats2bfloat162_rn(v[2], v[3]);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
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

// bias -> activation -> residual, the epilogue before any layer_norm
__device__ __forceinline__ float pre_norm(float v, long long r, int c, int N,
                                          const Epilogue& ep) {
  if (ep.bias) v += ep.bias[c];
  v = activate(v, ep.act);
  if (ep.residual) v += ep.residual[r * N + c];
  return v;
}

// acc = x[m0:m0+TBM, :] @ y[:, n0:n0+TBN] for this thread's TM_ x TN_
// accumulators.  Thread (ty, tx) owns rows g * (TBM*4/TM_) + ty*4 + i and
// columns g * (TBN*4/TN_) + tx*4 + j: groups of 4 spread over the tile so
// the shared-memory reads of a warp are conflict-free float4s.
template <typename Tin, int TBM, int TBN, int TM_, int TN_>
__device__ __forceinline__ void gemm_tile(
    const Tin* __restrict__ x, const Tin* __restrict__ y, int M, int N,
    int K, int m0, int n0, float (*As)[TBM], float (*Bs)[TBN],
    float acc[TM_][TN_]) {
  constexpr int NT = (TBM / TM_) * (TBN / TN_);
  const int tid = threadIdx.x;
  const int tx = tid % (TBN / TN_), ty = tid / (TBN / TN_);
#pragma unroll
  for (int i = 0; i < TM_; ++i)
#pragma unroll
    for (int j = 0; j < TN_; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile: TBM rows x BK columns, stored transposed (As[k][m])
    for (int idx = tid; idx < TBM * BK / 4; idx += NT) {
      const int r = idx / (BK / 4), c = (idx % (BK / 4)) * 4;
      const int gm = m0 + r, gk = k0 + c;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (gm < M && gk < K) load4(x + (long long)gm * K + gk, v);
      As[c][r] = v[0];
      As[c + 1][r] = v[1];
      As[c + 2][r] = v[2];
      As[c + 3][r] = v[3];
    }
    // y tile: BK rows x TBN columns (Bs[k][n])
    for (int idx = tid; idx < BK * TBN / 4; idx += NT) {
      const int r = idx / (TBN / 4), c = (idx % (TBN / 4)) * 4;
      const int gk = k0 + r, gn = n0 + c;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (gk < K && gn < N) load4(y + (long long)gk * N + gn, v);
      *reinterpret_cast<float4*>(&Bs[r][c]) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM_], b[TN_];
#pragma unroll
      for (int g = 0; g < TM_ / 4; ++g) {
        const float4 t = *reinterpret_cast<const float4*>(
            &As[kk][g * (TBM * 4 / TM_) + ty * 4]);
        a[4 * g] = t.x; a[4 * g + 1] = t.y;
        a[4 * g + 2] = t.z; a[4 * g + 3] = t.w;
      }
#pragma unroll
      for (int g = 0; g < TN_ / 4; ++g) {
        const float4 t = *reinterpret_cast<const float4*>(
            &Bs[kk][g * (TBN * 4 / TN_) + tx * 4]);
        b[4 * g] = t.x; b[4 * g + 1] = t.y;
        b[4 * g + 2] = t.z; b[4 * g + 3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < TM_; ++i)
#pragma unroll
        for (int j = 0; j < TN_; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const Tin* __restrict__ x, const Tin* __restrict__ y,
            Epilogue ep, Tout* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  float acc[TM][TN];
  gemm_tile<Tin, BM, BN, TM, TN>(x, y, M, N, K, m0, n0, As, Bs, acc);

  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
#pragma unroll
  for (int gi = 0; gi < TM / 4; ++gi) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m0 + gi * (BM * 4 / TM) + ty * 4 + i;
      if (r >= M) continue;
#pragma unroll
      for (int gj = 0; gj < TN / 4; ++gj) {
        const int c = n0 + gj * (BN * 4 / TN) + tx * 4;
        if (c >= N) continue;            // N % 4 == 0: all four or none
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = pre_norm(acc[gi * 4 + i][gj * 4 + j], r, c + j, N, ep);
        store4(out + (long long)r * N + c, v);
      }
    }
  }
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(THREADS)
gemm_ln_kernel(const Tin* __restrict__ x, const Tin* __restrict__ y,
               Epilogue ep, Tout* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) float As[BK][LN_BM];
  __shared__ __align__(16) float Bs[BK][BN];
  extern __shared__ __align__(16) float rows[];   // [LN_BM][N] pre-norm
  const int m0 = blockIdx.x * LN_BM;
  const int tx = threadIdx.x % (BN / LN_TN), ty = threadIdx.x / (BN / LN_TN);

  for (int n0 = 0; n0 < N; n0 += BN) {
    float acc[LN_TM][LN_TN];
    gemm_tile<Tin, LN_BM, BN, LN_TM, LN_TN>(x, y, M, N, K, m0, n0, As, Bs,
                                            acc);
#pragma unroll
    for (int i = 0; i < LN_TM; ++i) {
      const int rl = ty * 4 + i;
      if (m0 + rl >= M) continue;
#pragma unroll
      for (int j = 0; j < LN_TN; ++j) {
        const int c = n0 + tx * 4 + j;
        if (c < N) rows[rl * N + c] = pre_norm(acc[i][j], m0 + rl, c, N, ep);
      }
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float inv_n = 1.f / (float)N;
  for (int rl = warp; rl < LN_BM; rl += THREADS / 32) {
    const long long r = m0 + rl;
    if (r >= M) break;
    const float* row = rows + rl * N;
    float s = 0.f;
    for (int c = lane; c < N; c += 32) s += row[c];
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
      store1(out + r * N + c, v);
    }
  }
}

template <typename Tin, typename Tout>
int launch(const void* x, const void* y, const Epilogue& ep, void* out,
           int M, int N, int K, int layer_norm, cudaStream_t stream) {
  if (layer_norm) {
    const int smem = (int)(sizeof(float) * LN_BM * (size_t)N);
    cudaError_t err = cudaFuncSetAttribute(
        gemm_ln_kernel<Tin, Tout>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    gemm_ln_kernel<Tin, Tout><<<(M + LN_BM - 1) / LN_BM, THREADS, smem,
                                stream>>>((const Tin*)x, (const Tin*)y, ep,
                                          (Tout*)out, M, N, K);
  } else {
    dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
    gemm_kernel<Tin, Tout><<<grid, THREADS, 0, stream>>>(
        (const Tin*)x, (const Tin*)y, ep, (Tout*)out, M, N, K);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_gemm(const void* x, const void* y, const void* bias,
                          const void* residual, const void* ln_scale,
                          const void* ln_bias, void* out, int M, int N, int K,
                          int activation, int layer_norm, float ln_eps,
                          int in_bf16, int out_bf16, void* stream) {
  if (M < 1 || N < 1 || K < 1 || N % 4 || K % 4 || activation < ACT_NONE ||
      activation > ACT_GELU_TANH || (N + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  Epilogue ep{(const float*)bias, (const float*)residual,
              (const float*)ln_scale, (const float*)ln_bias, activation,
              ln_eps};
  cudaStream_t s = (cudaStream_t)stream;
  if (in_bf16) {
    if (out_bf16)
      return launch<__nv_bfloat16, __nv_bfloat16>(x, y, ep, out, M, N, K,
                                                  layer_norm, s);
    return launch<__nv_bfloat16, float>(x, y, ep, out, M, N, K, layer_norm,
                                        s);
  }
  if (out_bf16)
    return launch<float, __nv_bfloat16>(x, y, ep, out, M, N, K, layer_norm,
                                        s);
  return launch<float, float>(x, y, ep, out, M, N, K, layer_norm, s);
}
