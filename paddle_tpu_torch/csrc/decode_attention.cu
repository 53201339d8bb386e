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
// the type of q); lengths [B] int32.  f32 softmax and accumulator; in bf16
// P is cast to bf16 before P.V, as the TPU kernel does.
//
// What bounds it on the H100: bytes.  A decode step does 4 * D FLOPs per
// visible key and row against 2 * D * sizeof(T) bytes of cache per key: at
// q_len 1 that is 1 FLOP/byte (f32), far below the ridge, so the floor is
// the K/V rows the lengths make visible, read once, over 3.35 TB/s.
//
// What the design does about it (flash-decoding): every visible K/V byte
// is read once, by all SMs at once, in 16-byte copies.
//  * Split-K over the cache.  The grid is (b*h, split): each block walks a
//    fixed run of `split` keys (the wrapper picks it from S_max).  The host
//    cannot read the lengths without a sync, so the grid is sized from
//    S_max, and a block whose run starts at or past min(S_max,
//    L + q_len - 1) loads nothing.
//  * The splits of one b*h form a thread-block cluster (at most 8 blocks).
//    Each block leaves its partial (m, l, acc[q_len][D]) in its shared
//    memory; after a cluster barrier the blocks read each other's partials
//    through distributed shared memory and combine them in split order.
//    One launch, no workspace, no atomics: a run is bit-identical to the
//    next.
//  * Loads go straight from memory to registers, 16 bytes a lane, all of
//    a round's keys issued before any is used.  (A cp.async ring in
//    shared memory, and loading the next round ahead, measured slower on
//    the H100: the ring's 48 KB and the extra registers cost more blocks
//    an SM than they hide.)  No divide or modulo per element.
//  * Inside a block the 4 warps split each round's keys, not the query
//    rows, so all of them work at q_len 1, and combine through shared
//    memory in warp order.
//  * f32 (CUDA cores, no TF32): a group of D/4 lanes holds one key row, 4
//    floats a lane, and each lane keeps its 4 columns of every query row
//    in registers; a dot product is 4 FMAs and a sum over the group by
//    shuffles (at q_len 8 a reduce-scatter, so a lane ends with one
//    (key, row) score and takes one exp).
//  * bf16 (tensor cores): per 16 keys a warp computes S = Q.K^T and
//    O += P.V with mma.sync.m16n8k16 (the query rows are M, the 8 rows
//    past q_len zero).  K and V stay bf16 from memory to the fragments,
//    with no shared memory.  The dot product's k order is permuted so
//    that a lane's 16-byte load of 8 consecutive columns of a K row is
//    its B fragment of S (and Q is loaded the same way), and P.V's output
//    columns are permuted so that a lane's 16-byte loads of 4 V rows hold
//    its B fragments after one byte-permute per register; the store
//    undoes the permutation.
// Head dims are compiled at 64 and 128; a smaller multiple of 8 is
// zero-padded on load.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NW = 4;                 // warps a block
constexpr int THREADS = NW * 32;
constexpr int MAX_ROWS = 8;
constexpr int MAX_D = 128;
constexpr int MAX_SPLITS = 8;         // blocks of one b*h's cluster
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* o;
  int q_len, S, D, num_heads, split;
  float scale;
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes from global memory, read once: not kept in L1
__device__ __forceinline__ uint4 ld16(const void* p, bool in) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (in) r = __ldcs(reinterpret_cast<const uint4*>(p));
  return r;
}

// The partials each warp leaves in shared memory, the block's combination
// of them, and the cluster's combination of the blocks' into o.
template <int ROWS, int DC>
struct Partials {
  float acc[NW][ROWS][DC];
  float m[NW][ROWS];
  float l[NW][ROWS];
  float bacc[ROWS][DC];
  float bm[ROWS];
  float bl[ROWS];
};

template <int ROWS, int DC, typename T>
__device__ __forceinline__ void combine(Partials<ROWS, DC>& sp,
                                        const Params& a, int bh) {
  __syncthreads();
  // the block's partial: its warps' in warp order
  for (int idx = threadIdx.x; idx < ROWS * DC; idx += THREADS) {
    const int r = idx / DC, d = idx % DC;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sp.m[w][r]);
    const float ms = mx > NEG_INF * 0.5f ? mx : 0.f;
    float l = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float e = __expf(sp.m[w][r] - ms);
      l = fmaf(sp.l[w][r], e, l);
      acc = fmaf(sp.acc[w][r][d], e, acc);
    }
    sp.bacc[r][d] = acc;
    if (d == 0) {
      sp.bm[r] = mx;
      sp.bl[r] = l;
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  // o: the cluster's blocks' partials in split order, read through
  // distributed shared memory; the blocks share out the outputs
  const int n = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  T* o = (T*)a.o + (long long)bh * a.q_len * a.D;
  for (int idx = threadIdx.x + rank * THREADS; idx < a.q_len * DC;
       idx += n * THREADS) {
    const int r = idx / DC, d = idx % DC;
    if (d >= a.D) continue;
    float mj[MAX_SPLITS], lj[MAX_SPLITS], aj[MAX_SPLITS];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j) {
      if (j < n) {
        Partials<ROWS, DC>* rp = cluster.map_shared_rank(&sp, j);
        mj[j] = rp->bm[r];
        lj[j] = rp->bl[r];
        aj[j] = rp->bacc[r][d];
        mx = fmaxf(mx, mj[j]);
      }
    }
    const float ms = mx > NEG_INF * 0.5f ? mx : 0.f;
    float l = 0.f, acc = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j) {
      if (j < n) {
        const float e = __expf(mj[j] - ms);
        l = fmaf(lj[j], e, l);
        acc = fmaf(aj[j], e, acc);
      }
    }
    store(o + r * a.D + d, l > 0.f ? acc / l : 0.f);
  }
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

// ---------------------------------------------------------------- f32
// c ? x : y on values in registers (a plain ?: of two array elements may
// become a select of their addresses, which sends the array to local
// memory)
__device__ __forceinline__ float select(bool c, float x, float y) {
  float r;
  asm("{\n .reg .pred p;\n setp.ne.b32 p, %3, 0;\n"
      " selp.f32 %0, %1, %2, p;\n}"
      : "=f"(r)
      : "f"(x), "f"(y), "r"((int)c));
  return r;
}

// One level of a reduce-scatter over lanes: of the N partial sums in
// v[0 .. N), a lane whose bit `off` is set keeps the upper half, its
// partner the lower, each adding the other's; the kept half moves to
// v[0 .. N/2).
template <int N>
__device__ __forceinline__ void scatter_level(float* v, int off, int lane) {
  const bool upper = (lane & off) != 0;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float keep = select(upper, v[i + N / 2], v[i]);
    const float send = select(upper, v[i], v[i + N / 2]);
    v[i] = keep + __shfl_xor_sync(FULL, send, off);
  }
}

// DC: compiled head dim (64 | 128); ROWS: query rows held (1 | 8, q_len
// <= ROWS; rows past q_len have q = 0 and are not stored).  Each lane
// loads U keys of K and of V a round (8 for one row, 2 for eight), the
// round's keys rb + w * KPW * U + u * KPW + group for warp w.
//  ROWS 1: each lane sums its U dot products over its group by shuffles
//  and keeps the row's softmax state.
//  ROWS 8 (U 2): the 16 (key u, row r) dot products of a lane's group
//  are reduce-scattered over it (offsets 8, 4, 2, 1: a lane keeps the
//  half whose index bit matches its lane bit), 15 shuffles, so lane l
//  holds item l & 15 = (u = l >> 3 & 1, r = l & 7) and keeps row r's
//  softmax state: one exp a lane, not 16.  The row max is taken over
//  both groups, so the groups share m and their sums simply add.
template <int DC, int ROWS>
__global__ void __launch_bounds__(THREADS, 3)
decode_kernel_f32(const Params a) {
  static_assert(ROWS == 1 || ROWS == MAX_ROWS, "f32 rows");
  constexpr int U = ROWS == 1 ? 8 : 2;
  constexpr int G = DC / 4;           // lanes of one key row
  constexpr int KPW = 32 / G;         // key rows a warp load covers
  constexpr int STEP = NW * KPW * U;  // keys a block round covers
  __shared__ __align__(16) Partials<ROWS, DC> sp;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / G, li = lane % G;
  const int bh = blockIdx.x;
  const int L = a.lengths[bh / a.num_heads];
  const int k_end = max(0, min(a.S, L + a.q_len - 1));
  const int lo = blockIdx.y * a.split;
  const int hi = min(lo + a.split, k_end);
  const int col = 4 * li;
  const bool dcol = col < a.D;
  const float* kc = (const float*)a.k + (long long)bh * a.S * a.D + col;
  const float* vc = (const float*)a.v + (long long)bh * a.S * a.D + col;

  float qr[ROWS][4], acc[ROWS][4];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float* qp = (const float*)a.q + ((long long)bh * a.q_len + r) * a.D
                      + col;
    const uint4 w = ld16(qp, r < a.q_len && dcol);
    qr[r][0] = __uint_as_float(w.x) * a.scale;
    qr[r][1] = __uint_as_float(w.y) * a.scale;
    qr[r][2] = __uint_as_float(w.z) * a.scale;
    qr[r][3] = __uint_as_float(w.w) * a.scale;
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
  }
  // the softmax state of this lane's row (ROWS 1: the row; ROWS 8: row
  // lane & 7, l summed over this lane's items only)
  const int my_u = ROWS == 1 ? 0 : (lane >> 3) & 1;
  const int my_r = ROWS == 1 ? 0 : lane & 7;
  const int my_vis = min(hi, L + my_r);         // keys my row sees here
  float m = NEG_INF, l = 0.f;

  for (int rb = lo; rb < hi; rb += STEP) {
    const int k0 = rb + warp * KPW * U + grp;   // this lane's first key
    float4 kv[U], vv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = k0 + u * KPW;
      const bool in = key < hi && dcol;
      const uint4 kw = ld16(kc + (long long)key * a.D, in);
      const uint4 vw = ld16(vc + (long long)key * a.D, in);
      kv[u] = make_float4(__uint_as_float(kw.x), __uint_as_float(kw.y),
                          __uint_as_float(kw.z), __uint_as_float(kw.w));
      vv[u] = make_float4(__uint_as_float(vw.x), __uint_as_float(vw.y),
                          __uint_as_float(vw.z), __uint_as_float(vw.w));
    }
    // the (key u, row r) dot products of this lane's columns, item u*ROWS+r
    float v[U * ROWS];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float d = qr[r][0] * kv[u].x;
        d = fmaf(qr[r][1], kv[u].y, d);
        d = fmaf(qr[r][2], kv[u].z, d);
        v[u * ROWS + r] = fmaf(qr[r][3], kv[u].w, d);
      }
    if constexpr (ROWS == 1) {
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < U; ++u) v[u] += __shfl_xor_sync(FULL, v[u], off);
      float mt = m;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        v[u] = k0 + u * KPW < my_vis ? v[u] : NEG_INF;
        mt = fmaxf(mt, v[u]);
      }
      const float ms = mt > NEG_INF * 0.5f ? mt : 0.f;
      const float corr = __expf(m - ms);
      float ps = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][e] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = __expf(v[u] - ms);
        ps += p;
        acc[0][0] = fmaf(p, vv[u].x, acc[0][0]);
        acc[0][1] = fmaf(p, vv[u].y, acc[0][1]);
        acc[0][2] = fmaf(p, vv[u].z, acc[0][2]);
        acc[0][3] = fmaf(p, vv[u].w, acc[0][3]);
      }
      l = fmaf(l, corr, ps);
      m = mt;
    } else {
      scatter_level<16>(v, 8, lane);
      scatter_level<8>(v, 4, lane);
      scatter_level<4>(v, 2, lane);
      scatter_level<2>(v, 1, lane);
      if (G == 32) v[0] += __shfl_xor_sync(FULL, v[0], 16);
      const float sv = k0 + my_u * KPW < my_vis ? v[0] : NEG_INF;
      float mt = fmaxf(m, fmaxf(sv, __shfl_xor_sync(FULL, sv, 8)));
      mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 16));
      const float ms = mt > NEG_INF * 0.5f ? mt : 0.f;
      const float corr = __expf(m - ms);
      const float p = __expf(sv - ms);
      l = fmaf(l, corr, p);
      m = mt;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float c = __shfl_sync(FULL, corr, r);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][e] *= c;
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float pr = __shfl_sync(FULL, p, grp * G + u * 8 + r);
          acc[r][0] = fmaf(pr, vv[u].x, acc[r][0]);
          acc[r][1] = fmaf(pr, vv[u].y, acc[r][1]);
          acc[r][2] = fmaf(pr, vv[u].z, acc[r][2]);
          acc[r][3] = fmaf(pr, vv[u].w, acc[r][3]);
        }
    }
  }

  if constexpr (ROWS == 1) {
    // the warp's KPW key groups, lower group first
#pragma unroll
    for (int off = G; off < 32; off <<= 1) {
      const float mo = __shfl_xor_sync(FULL, m, off);
      const float lo_ = __shfl_xor_sync(FULL, l, off);
      const float mx = fmaxf(m, mo);
      const float ms = mx > NEG_INF * 0.5f ? mx : 0.f;
      const bool first = (lane & off) == 0;
      const float fa = __expf((first ? m : mo) - ms);
      const float fb = __expf((first ? mo : m) - ms);
      const float la = first ? l : lo_, lb = first ? lo_ : l;
      l = fmaf(lb, fb, la * fa);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ao = __shfl_xor_sync(FULL, acc[0][e], off);
        const float aa = first ? acc[0][e] : ao, ab = first ? ao : acc[0][e];
        acc[0][e] = fmaf(ab, fb, aa * fa);
      }
      m = mx;
    }
  } else {
    // row r's l over its items: lanes r, r + 8 (and, with two groups,
    // r + 16, r + 24; with one group those repeat r, r + 8); the groups
    // share m, so their sums add
    l += __shfl_xor_sync(FULL, l, 8);
    if (KPW == 2) {
      l += __shfl_xor_sync(FULL, l, 16);
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[r][e] += __shfl_xor_sync(FULL, acc[r][e], 16);
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      *reinterpret_cast<float4*>(&sp.acc[warp][r][col]) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  if (lane < ROWS) {                  // lane r holds row r's m and l
    sp.m[warp][lane] = m;
    sp.l[warp][lane] = l;
  }
  combine<ROWS, DC, float>(sp, a, bh);
}

// ---------------------------------------------------------------- bf16
__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// DC: compiled head dim (64 | 128).  A round's 64 keys: warp w's 16 are
// rb + 16w .. + 15.  Lane (g, t) = (lane / 4, lane % 4): query row g; in
// S = Q.K^T (two n8 tiles) it supplies keys g and g + 8 as B, the 8
// columns at 32c + 8t of every 32-column chunk c; in O += P.V it supplies
// V rows 2t, 2t+1, 2t+8, 2t+9, columns 64h + 8g .. + 7 of every 64-column
// half h.  (Loading the next round ahead, or two steps a round, measured
// slower on the H100: the extra registers cost more blocks an SM than
// they hide.)
template <int DC>
__global__ void __launch_bounds__(THREADS, 3)
decode_kernel_bf16(const Params a) {
  using bf16 = __nv_bfloat16;
  constexpr int NC = DC / 32;         // 32-column chunks of a K row
  constexpr int NH = DC / 64;         // 64-column halves of a V row
  constexpr int NT = DC / 8;          // n8 tiles of O
  constexpr int STEP = NW * 16;       // keys a block round covers
  __shared__ __align__(16) Partials<MAX_ROWS, DC> sp;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int L = a.lengths[bh / a.num_heads];
  const int k_end = max(0, min(a.S, L + a.q_len - 1));
  const int lo = blockIdx.y * a.split;
  const int hi = min(lo + a.split, k_end);
  const int vis = min(hi, L + g);               // keys row g sees here
  const bf16* kc = (const bf16*)a.k + (long long)bh * a.S * a.D;
  const bf16* vc = (const bf16*)a.v + (long long)bh * a.S * a.D;

  // Q's A fragments (rows g; the rows g + 8 are zero): chunk c's 8
  // columns at 32c + 8t give the k pairs of two k16 steps
  uint4 qf[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int d0 = 32 * c + 8 * t;
    qf[c] = ld16((const bf16*)a.q + ((long long)bh * a.q_len + g) * a.D + d0,
                 g < a.q_len && d0 < a.D);
  }
  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m = NEG_INF, l = 0.f;

  for (int rb = lo; rb < hi; rb += STEP) {
    const int kb = rb + 16 * warp;
    // this lane's K and V rows of the warp's 16 keys (zeros past hi)
    uint4 k0[NC], k1[NC], vr[4][NH];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d0 = 32 * c + 8 * t;
      k0[c] = ld16(kc + (long long)(kb + g) * a.D + d0,
                   kb + g < hi && d0 < a.D);
      k1[c] = ld16(kc + (long long)(kb + g + 8) * a.D + d0,
                   kb + g + 8 < hi && d0 < a.D);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = kb + 2 * t + (i & 1) + 8 * (i >> 1);
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const int d0 = 64 * h + 8 * g;
        vr[i][h] = ld16(vc + (long long)key * a.D + d0,
                        key < hi && d0 < a.D);
      }
    }
    // S^T tiles: s0 keys kb + 2t (+1), s1 keys kb + 8 + 2t (+1), row g
    float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const uint32_t qa[4] = {qf[c].x, 0u, qf[c].y, 0u};
      const uint32_t qb[4] = {qf[c].z, 0u, qf[c].w, 0u};
      const uint32_t b0a[2] = {k0[c].x, k0[c].y}, b0b[2] = {k0[c].z, k0[c].w};
      const uint32_t b1a[2] = {k1[c].x, k1[c].y}, b1b[2] = {k1[c].z, k1[c].w};
      sm90::mma_bf16(s0, qa, b0a);
      sm90::mma_bf16(s0, qb, b0b);
      sm90::mma_bf16(s1, qa, b1a);
      sm90::mma_bf16(s1, qb, b1b);
    }
    float s[4] = {s0[0], s0[1], s1[0], s1[1]};
    float mt = m;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = kb + 2 * t + (i & 1) + 8 * (i >> 1);
      s[i] = key < vis ? s[i] * a.scale : NEG_INF;
      mt = fmaxf(mt, s[i]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 2));
    const float ms = mt > NEG_INF * 0.5f ? mt : 0.f;
    const float corr = __expf(m - ms);
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = __expf(s[i] - ms);
    l = fmaf(l, corr, (p[0] + p[1]) + (p[2] + p[3]));
    m = mt;
    // P (bf16, as the TPU kernel casts it) as the A operand of P.V
    const uint32_t pa[4] = {sm90::pack_bf16(p[0], p[1]), 0u,
                            sm90::pack_bf16(p[2], p[3]), 0u};
#pragma unroll
    for (int h = 0; h < NH; ++h) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // n8 tile (h, j): its column n is the head column 64h + 8n + j;
        // this lane's B column g is element j of its V loads
        const uint32_t sel = (j & 1) ? 0x7632u : 0x5410u;
        const uint32_t b[2] = {
            __byte_perm(word(vr[0][h], j >> 1), word(vr[1][h], j >> 1), sel),
            __byte_perm(word(vr[2][h], j >> 1), word(vr[3][h], j >> 1),
                        sel)};
        o[8 * h + j][0] *= corr;
        o[8 * h + j][1] *= corr;
        sm90::mma_bf16(o[8 * h + j], pa, b);
      }
    }
  }

  l += __shfl_xor_sync(FULL, l, 1);
  l += __shfl_xor_sync(FULL, l, 2);
  // O's tile (h, j) holds row g, columns 2t and 2t + 1: head columns
  // 64h + 16t + j and 64h + 16t + 8 + j
#pragma unroll
  for (int h = 0; h < NH; ++h) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sp.acc[warp][g][64 * h + 16 * t + j] = o[8 * h + j][0];
      sp.acc[warp][g][64 * h + 16 * t + 8 + j] = o[8 * h + j][1];
    }
  }
  if (t == 0) {
    sp.m[warp][g] = m;
    sp.l[warp][g] = l;
  }
  combine<MAX_ROWS, DC, bf16>(sp, a, bh);
}

// ---------------------------------------------------------------- launch
template <typename Kernel>
int launch(Kernel kernel, const Params& a, int BH, int nsplit,
           cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(BH, nsplit, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = nsplit;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int DC>
int dispatch(const Params& a, int BH, int nsplit, bool bf16,
             cudaStream_t s) {
  if (bf16) return launch(decode_kernel_bf16<DC>, a, BH, nsplit, s);
  return a.q_len == 1
             ? launch(decode_kernel_f32<DC, 1>, a, BH, nsplit, s)
             : launch(decode_kernel_f32<DC, MAX_ROWS>, a, BH, nsplit, s);
}

}  // namespace

// split: keys each block of a b*h's cluster walks (a multiple of 16, with
// ceil(S / split) <= 8 blocks); the wrapper picks it from S.
extern "C" int decode_attention(const void* q, const void* k_cache,
                                const void* v_cache, const void* lengths,
                                void* o, int BH, int q_len, int S, int D,
                                int num_heads, int split, float scale,
                                int is_bf16, void* stream) {
  if (q_len < 1 || q_len > MAX_ROWS || D < 8 || D > MAX_D || D % 8 ||
      S < 1 || split < 16 || split % 16 || num_heads < 1 || BH < 1)
    return (int)cudaErrorInvalidValue;
  const int nsplit = (S + split - 1) / split;
  if (nsplit > MAX_SPLITS) return (int)cudaErrorInvalidValue;
  const Params a{q, k_cache, v_cache, (const int*)lengths, o,
                 q_len, S, D, num_heads, split, scale};
  cudaStream_t s = (cudaStream_t)stream;
  return D <= 64 ? dispatch<64>(a, BH, nsplit, is_bf16 != 0, s)
                 : dispatch<128>(a, BH, nsplit, is_bf16 != 0, s);
}
