// Shared by the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_dq.cu, flash_attention_dkv.cu): tile sizes, element
// loads and stores, and the dropout mask.
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
#include <stdint.h>

namespace flash {

constexpr int BQ = 64;                 // query rows per tile
constexpr int BK = 64;                 // key rows per tile
constexpr int THREADS = 256;
constexpr int TPR = 4;                 // threads per tile row
constexpr int MAX_D = 128;
constexpr int NC = BK / TPR;           // tile columns per thread (16)
constexpr int ND = MAX_D / TPR;        // head-dim columns per thread (<= 32)
constexpr float NEG_INF = -1e30f;      // finite mask sentinel

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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

// Copy rows [row0, row0 + 64) of a [rows, D] matrix into a padded f32 tile
// (row stride D + 1), zeros past the last row.
template <typename T>
__device__ __forceinline__ void load_tile(float* tile, const T* src,
                                          int row0, int rows, int D) {
  const int ld = D + 1;
  for (int idx = threadIdx.x; idx < BQ * D; idx += THREADS) {
    const int rr = idx / D, cc = idx % D;
    const int g = row0 + rr;
    tile[rr * ld + cc] = g < rows ? to_f32(src[(long long)g * D + cc]) : 0.f;
  }
}

// The same rows of two matrices of one shape (K and V, or Q and dO).
template <typename T>
__device__ __forceinline__ void load_tiles(float* tile_a, float* tile_b,
                                           const T* a, const T* b, int row0,
                                           int rows, int D) {
  const int ld = D + 1;
  for (int idx = threadIdx.x; idx < BQ * D; idx += THREADS) {
    const int rr = idx / D, cc = idx % D;
    const int g = row0 + rr;
    const bool in = g < rows;
    const long long off = (long long)g * D + cc;
    tile_a[rr * ld + cc] = in ? to_f32(a[off]) : 0.f;
    tile_b[rr * ld + cc] = in ? to_f32(b[off]) : 0.f;
  }
}

}  // namespace flash
