// Flash attention's gradient for Hopper: dQ, dK and dV of the forward
// kernel's function (csrc/flash_attention.cu), in three launches.
//
// Replaces no TPU kernel: the reference package has no backward Pallas
// kernel.  Its model trains through jax autodiff of the plain
// chunked_attention (src/repro/models/attention.py:70); the port's model
// runs the forward in the flash kernel on the card, so its gradient is a
// kernel too (kernels/flash_attention.py, FlashAttention).
//
// Layouts are the forward's: q, dq (B, Sq, KV, G, dh); k, dk (B, Sk, KV,
// dh); v, dv (B, Sk, KV, dv); o, dout (B, Sq, KV, G, dv); all fp32 or all
// bf16, dh and dv each up to 256.  The mask is the forward's: keys past Sk
// are never seen, and under causal a row sees the keys up to itself and
// every key before prefix_len.  The scale is the true dh's, dh^-0.5.
//
//   1. stats: per (head, q tile), the row statistics the forward keeps on
//      chip and does not write: lse = m + log(l) over the visible keys
//      (an online pass over the key tiles, as the forward's), and
//      D = rowsum(dO * O), both fp32.
//   2. dK, dV: per (b, kv head, key tile), a walk over the group's G heads
//      and only the q tiles that see the tile: P^T = exp(S^T * scale - lse)
//      recomputed, dV += P^T dO, dS^T = P^T * (dP^T - D) with
//      dP^T = V dO^T, dK += dS^T Q, all accumulated in fp32 and written
//      once (dK times the scale).  GQA's sum over the G heads of a group is
//      the walk itself, so no two blocks write one element.
//   3. dQ: per (head, q tile), the forward's walk over the visible key
//      tiles: dQ += dS K, written once times the scale.
// No atomics: every output element has one writer, so two runs give the
// same bits.
//
// What bounds it on an H100: about 2.5x the forward's flops (the products
// Q K^T twice, dO V^T twice, P^T dO, dS^T Q and dS K, against the
// forward's two), so at the served shapes the bf16 tensor-core rate.  This
// first design is simple: each product is mma.sync m16n8k16 (bf16
// operands, fp32 accumulate) from shared-memory tiles staged by all
// threads, with no pipelining; P and dS are rounded to bf16 where they
// enter a product (the forward's p.astype(v.dtype) rounding point), dS
// taken from the unrounded P.  fp32 runs the same tiles and layouts on
// CUDA-core FMAs (fp32 products, as the forward's fp32 body).  Tiles are
// 64 rows a side in bf16 and 32 in fp32, whose shared memory would not
// hold 64-row tiles at 256 columns.  Above 64 columns the dK/dV block
// walks the q tiles twice (dV first, then dK), so a thread holds one
// accumulator of D/2 floats at a time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr float kNegInf = -1e30f;

// The forward's mask (csrc/flash_attention.cu visible / kv_end_of).
__device__ __forceinline__ bool visible(int key, int row, int sk, int causal,
                                        int prefix_len) {
  return key < sk && (!causal || key <= row || key < prefix_len);
}

__device__ __forceinline__ int kv_end_of(int row_end, int sk, int causal,
                                         int prefix_len) {
  return causal ? max(min(sk, row_end), min(sk, prefix_len)) : sk;
}

// Tile geometry by element type: BR rows a tile side (q rows or keys),
// 16 per warp; rows of a [BR][D] tile padded by 16 bytes, and the
// transposed tiles and the P / dS tile ([.][BR]) likewise, so that a
// warp's 32-bit fragment loads hit distinct banks.
template <typename T> struct Geo {
  static constexpr int BR = sizeof(T) == 2 ? 64 : 32;
  static constexpr int WARPS = BR / 16;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int PAD = 16 / (int)sizeof(T);
  static constexpr int VEC = 16 / (int)sizeof(T);  // elements a 16-byte load
  static constexpr int LT = BR + PAD;
};

template <typename T, int D> __host__ __device__ constexpr int row_ld() {
  return D + Geo<T>::PAD;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// Rows [row0, row0 + BR) of one head into dst[r][c] (row stride
// row_ld<T, D>), zero past `rows` and for c in [cols, D).  `vec`: 16-byte
// loads (cols a multiple of Geo<T>::VEC, 16-byte aligned rows).
template <typename T, int D>
__device__ __forceinline__ void stage_rows(T* dst, const T* src,
                                           int64_t row_stride, int row0,
                                           int rows, int cols, bool vec) {
  constexpr int BR = Geo<T>::BR, LD = row_ld<T, D>(), NT = Geo<T>::THREADS;
  if (vec) {
    constexpr int V = Geo<T>::VEC, CH = D / V;
    for (int e = threadIdx.x; e < BR * CH; e += NT) {
      const int r = e / CH;
      const int c = (e - r * CH) * V;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (c < cols && row0 + r < rows)
        x = *reinterpret_cast<const uint4*>(
            src + (int64_t)(row0 + r) * row_stride + c);
      *reinterpret_cast<uint4*>(dst + r * LD + c) = x;
    }
    return;
  }
  for (int e = threadIdx.x; e < BR * D; e += NT) {
    const int r = e / D;
    const int c = e - r * D;
    T x = from_f<T>(0.f);
    if (c < cols && row0 + r < rows)
      x = src[(int64_t)(row0 + r) * row_stride + c];
    dst[r * LD + c] = x;
  }
}

// A staged [BR][D] tile transposed into dst[c][r] (row stride LT).
template <typename T, int D>
__device__ __forceinline__ void transpose(T* dst, const T* src) {
  constexpr int BR = Geo<T>::BR, LD = row_ld<T, D>(), LT = Geo<T>::LT,
                NT = Geo<T>::THREADS;
  for (int e = threadIdx.x; e < BR * D; e += NT) {
    const int r = e % BR;
    const int c = e / BR;
    dst[c * LT + r] = src[r * LD + c];
  }
}

// lse and D of rows [row0, row0 + BR) of one head into shared memory (0
// past Sq: those rows' P is masked).
template <typename T>
__device__ __forceinline__ void stage_stats(float* ls, float* ds,
                                            const float* lse,
                                            const float* dsum, int row0,
                                            int sq) {
  for (int r = threadIdx.x; r < Geo<T>::BR; r += Geo<T>::THREADS) {
    const bool in = row0 + r < sq;
    ls[r] = in ? lse[row0 + r] : 0.f;
    ds[r] = in ? dsum[row0 + r] : 0.f;
  }
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c[j] += A B_j^T: A is this warp's 16 rows (row stride lda), B an [n][k]
// operand (row stride ldb) whose rows 8j .. 8j + 7 make n-tile j; the sum
// runs over k in steps of 16.  Only the first `nt` n-tiles and `ks` steps
// are taken.  c[j][e] is row gr + 8(e / 2), column 8j + 2tq + (e & 1) of
// the product (gr = lane / 4, tq = lane % 4): mma.sync m16n8k16's
// accumulator layout.
template <int NT, int KS>
__device__ __forceinline__ void mma_acc(float (&c)[NT][4], const bf16* a,
                                        int lda, const bf16* b, int ldb,
                                        int nt, int ks) {
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    if (kk < ks) {
      const bf16* ap = a + gr * lda + kk * 16 + 2 * tq;
      const uint32_t af[4] = {ld32(ap), ld32(ap + 8 * lda), ld32(ap + 8),
                              ld32(ap + 8 * lda + 8)};
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (j < nt) {
          const bf16* bp = b + (j * 8 + gr) * ldb + kk * 16 + 2 * tq;
          mma_bf16(c[j], af, ld32(bp), ld32(bp + 8));
        }
    }
  }
}

// The same product and layout in fp32, by FMA.
template <int NT, int KS>
__device__ __forceinline__ void mma_acc(float (&c)[NT][4], const float* a,
                                        int lda, const float* b, int ldb,
                                        int nt, int ks) {
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  for (int kx = 0; kx < ks * 16; ++kx) {
    const float a0 = a[gr * lda + kx];
    const float a1 = a[(gr + 8) * lda + kx];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (j < nt) {
        const float b0 = b[(j * 8 + 2 * tq) * ldb + kx];
        const float b1 = b[(j * 8 + 2 * tq + 1) * ldb + kx];
        c[j][0] = fmaf(a0, b0, c[j][0]);
        c[j][1] = fmaf(a0, b1, c[j][1]);
        c[j][2] = fmaf(a1, b0, c[j][2]);
        c[j][3] = fmaf(a1, b1, c[j][3]);
      }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
}

// This warp's 16 x 8·NT accumulator tile into its rows of dst (row stride
// ldp), rounded to T: the A operand of the next product.
template <typename T, int NT>
__device__ __forceinline__ void store_tile(T* dst, int ldp,
                                           const float (&c)[NT][4]) {
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dst[(gr + 8 * (e >> 1)) * ldp + j * 8 + 2 * tq + (e & 1)] =
          from_f<T>(c[j][e]);
}

// Pointers into one (b, kv, g) head of the forward's layouts.
struct Head {
  int64_t q_row, o_row, k_row, v_row;  // row strides (elements)
  int64_t q_off, o_off, k_off, v_off;  // offsets of the head's row 0
};

__device__ __forceinline__ Head head_of(int b, int kv, int gi, int sq,
                                        int sk, int kvh, int g, int dh,
                                        int dv) {
  Head h;
  h.q_row = (int64_t)kvh * g * dh;
  h.o_row = (int64_t)kvh * g * dv;
  h.k_row = (int64_t)kvh * dh;
  h.v_row = (int64_t)kvh * dv;
  h.q_off = (int64_t)b * sq * h.q_row + ((int64_t)kv * g + gi) * dh;
  h.o_off = (int64_t)b * sq * h.o_row + ((int64_t)kv * g + gi) * dv;
  h.k_off = (int64_t)b * sk * h.k_row + (int64_t)kv * dh;
  h.v_off = (int64_t)b * sk * h.v_row + (int64_t)kv * dv;
  return h;
}

// ---------------------------------------------------------------------------
// 1. Row statistics: lse and D per (head, q tile)
// ---------------------------------------------------------------------------
template <typename T, int D> constexpr int stats_smem() {
  return 2 * Geo<T>::BR * row_ld<T, D>() * (int)sizeof(T);
}

template <typename T, int D>
__global__ void __launch_bounds__(Geo<T>::THREADS)
    flash_bwd_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ o,
                           const T* __restrict__ dout,
                           float* __restrict__ lse, float* __restrict__ dsum,
                           int sq, int sk, int kvh, int g, int dh, int dv,
                           int causal, int prefix_len, float scale, int vec) {
  using G = Geo<T>;
  constexpr int BR = G::BR, LD = row_ld<T, D>(), NS = BR / 8;
  extern __shared__ uint4 smem16[];
  T* Qs = reinterpret_cast<T*>(smem16);
  T* Ks = Qs + BR * LD;

  const int head = blockIdx.x;  // (b, kv, g) flattened
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;
  const int b = head / (kvh * g);
  const Head hp = head_of(b, (head / g) % kvh, head % g, sq, sk, kvh, g, dh,
                          dv);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gr = lane >> 2, tq = lane & 3;
  const int row0 = q0 + warp * 16 + gr;  // this thread's rows: row0, +8
  const int warp_last_row = q0 + warp * 16 + 15;
  const int ksh = (dh + 15) / 16;

  stage_rows<T, D>(Qs, q + hp.q_off, hp.q_row, q0, sq, dh, vec);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int kv_end = kv_end_of(q0 + BR, sk, causal, prefix_len);
  const int n_tiles = (kv_end + BR - 1) / BR;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BR;
    __syncthreads();  // the previous K tile is consumed (and Q staged)
    stage_rows<T, D>(Ks, k + hp.k_off, hp.k_row, k0, sk, dh, vec);
    __syncthreads();
    if (causal && k0 > warp_last_row && k0 >= prefix_len) continue;
    float s[NS][4];
    zero(s);
    mma_acc<NS, D / 16>(s, Qs + warp * 16 * LD, LD, Ks, LD, NS, ksh);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * tq + (e & 1);
        const bool ok =
            visible(key, row0 + 8 * (e >> 1), sk, causal, prefix_len);
        s[j][e] = ok ? s[j][e] * scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      m_new[h] = fmaxf(m[h], mx[h]);
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * tq + (e & 1);
        const bool ok =
            visible(key, row0 + 8 * (e >> 1), sk, causal, prefix_len);
        sum[e >> 1] += ok ? expf(s[j][e] - m_new[e >> 1]) : 0.f;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = l[h] * expf(m[h] - m_new[h]) + sum[h];
      m[h] = m_new[h];
    }
  }
  float* lse_h = lse + (int64_t)head * sq;
  float* dsum_h = dsum + (int64_t)head * sq;
  if (tq == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row0 + 8 * h < sq)
        lse_h[row0 + 8 * h] = m[h] + logf(fmaxf(l[h], 1e-30f));

  // D = rowsum(dO * O) in fp32, one row at a time per warp.
  const T* oh = o + hp.o_off;
  const T* doh = dout + hp.o_off;
  for (int r = 0; r < 16; ++r) {
    const int row = q0 + warp * 16 + r;
    if (row >= sq) break;
    float acc = 0.f;
    for (int c = lane; c < dv; c += 32)
      acc += to_f(oh[(int64_t)row * hp.o_row + c]) *
             to_f(doh[(int64_t)row * hp.o_row + c]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) dsum_h[row] = acc;
  }
}

// ---------------------------------------------------------------------------
// 2. dK and dV per (b, kv head, key tile)
// ---------------------------------------------------------------------------
// Shared memory: K, V, Q, dO [BR][D]; Qt, dOt [D][BR]; P^T / dS^T [BR][BR];
// lse and D of the q tile's rows.
template <typename T, int D> constexpr int dkdv_smem() {
  using G = Geo<T>;
  return (4 * G::BR * row_ld<T, D>() + 2 * D * G::LT + G::BR * G::LT) *
             (int)sizeof(T) +
         2 * G::BR * (int)sizeof(float);
}

template <typename T> struct Smem2 {
  T *ks, *vs, *qs, *dos, *qt, *dot, *ps;
  float *ls, *ds;
};

// One walk over the q tiles that see this block's keys, accumulating dV
// (DO_DV) and / or dK (DO_DK), then their write.
template <typename T, int D, bool DO_DV, bool DO_DK>
__device__ __forceinline__ void dkdv_walk(
    const Smem2<T>& sm, const T* __restrict__ q, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    T* __restrict__ dk, T* __restrict__ dvo, int b, int kv, int k0, int sq,
    int sk, int kvh, int g, int dh, int dv, int causal, int prefix_len,
    float scale, int vec) {
  using G = Geo<T>;
  constexpr int BR = G::BR, LD = row_ld<T, D>(), LT = G::LT;
  constexpr int NS = BR / 8, ND = D / 8, KD = D / 16, KS = BR / 16;
  T *Ks = sm.ks, *Vs = sm.vs, *Qs = sm.qs, *dOs = sm.dos, *Qt = sm.qt,
    *dOt = sm.dot;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gr = lane >> 2, tq = lane & 3;
  const int key_w = k0 + warp * 16;  // this warp's first key
  const int ksh = (dh + 15) / 16, ksv = (dv + 15) / 16;
  const int nth = (dh + 7) / 8, ntv = (dv + 7) / 8;
  // Rows before k0 see no key of the tile, save the prefix's.
  const int qt0 = causal && k0 >= prefix_len ? k0 / BR : 0;
  const int nqt = (sq + BR - 1) / BR;
  T* pw = sm.ps + warp * 16 * LT;

  float av[DO_DV ? ND : 1][4], ak[DO_DK ? ND : 1][4];
  zero(av);
  zero(ak);
  for (int gi = 0; gi < g; ++gi) {
    const Head hp = head_of(b, kv, gi, sq, sk, kvh, g, dh, dv);
    const int64_t head = ((int64_t)b * kvh + kv) * g + gi;
    for (int qt = qt0; qt < nqt; ++qt) {
      const int q0 = qt * BR;
      __syncthreads();  // the previous q tile is consumed
      stage_rows<T, D>(Qs, q + hp.q_off, hp.q_row, q0, sq, dh, vec);
      stage_rows<T, D>(dOs, dout + hp.o_off, hp.o_row, q0, sq, dv, vec);
      stage_stats<T>(sm.ls, sm.ds, lse + head * sq, dsum + head * sq, q0,
                     sq);
      __syncthreads();
      if constexpr (DO_DK) transpose<T, D>(Qt, Qs);
      if constexpr (DO_DV) transpose<T, D>(dOt, dOs);
      __syncthreads();
      // No key of this warp is seen by a row of the tile: skip it.
      if (key_w >= sk ||
          (causal && key_w > q0 + BR - 1 && key_w >= prefix_len))
        continue;
      // S^T = K Q^T (this warp's 16 keys x the tile's rows), then P^T.
      float s[NS][4];
      zero(s);
      mma_acc<NS, KD>(s, Ks + warp * 16 * LD, LD, Qs, LD, NS, ksh);
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key_w + gr + 8 * (e >> 1);
          const int r = j * 8 + 2 * tq + (e & 1);
          const bool ok = q0 + r < sq &&
                          visible(key, q0 + r, sk, causal, prefix_len);
          s[j][e] = ok ? expf(s[j][e] * scale - sm.ls[r]) : 0.f;
        }
      if constexpr (DO_DV) {  // dV += P^T dO
        store_tile<T>(pw, LT, s);
        __syncwarp();
        mma_acc<ND, KS>(av, pw, LT, dOt, LT, ntv, KS);
        __syncwarp();
      }
      if constexpr (DO_DK) {  // dP^T = V dO^T; dS^T = P^T (dP^T - D); dK += dS^T Q
        float dp[NS][4];
        zero(dp);
        mma_acc<NS, KD>(dp, Vs + warp * 16 * LD, LD, dOs, LD, NS, ksv);
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[j][e] = s[j][e] * (dp[j][e] - sm.ds[j * 8 + 2 * tq + (e & 1)]);
        store_tile<T>(pw, LT, dp);
        __syncwarp();
        mma_acc<ND, KS>(ak, pw, LT, Qt, LT, nth, KS);
        __syncwarp();
      }
    }
  }
  const Head hp = head_of(b, kv, 0, sq, sk, kvh, g, dh, dv);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key_w + gr + 8 * h;
    if (key >= sk) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * tq + e;
        if constexpr (DO_DV)
          if (col < dv)
            dvo[hp.v_off + (int64_t)key * hp.v_row + col] =
                from_f<T>(av[j][2 * h + e]);
        if constexpr (DO_DK)
          if (col < dh)
            dk[hp.k_off + (int64_t)key * hp.k_row + col] =
                from_f<T>(ak[j][2 * h + e] * scale);
      }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Geo<T>::THREADS)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dsum, T* __restrict__ dk,
                          T* __restrict__ dvo, int sq, int sk, int kvh, int g,
                          int dh, int dv, int causal, int prefix_len,
                          float scale, int vec) {
  using G = Geo<T>;
  constexpr int BR = G::BR, LD = row_ld<T, D>(), LT = G::LT;
  extern __shared__ uint4 smem16[];
  Smem2<T> sm;
  sm.ks = reinterpret_cast<T*>(smem16);
  sm.vs = sm.ks + BR * LD;
  sm.qs = sm.vs + BR * LD;
  sm.dos = sm.qs + BR * LD;
  sm.qt = sm.dos + BR * LD;
  sm.dot = sm.qt + D * LT;
  sm.ps = sm.dot + D * LT;
  sm.ls = reinterpret_cast<float*>(sm.ps + BR * LT);
  sm.ds = sm.ls + BR;

  const int b = blockIdx.x / kvh;
  const int kv = blockIdx.x % kvh;
  const int k0 = blockIdx.y * BR;
  const Head hp = head_of(b, kv, 0, sq, sk, kvh, g, dh, dv);
  stage_rows<T, D>(sm.ks, k + hp.k_off, hp.k_row, k0, sk, dh, vec);
  stage_rows<T, D>(sm.vs, v + hp.v_off, hp.v_row, k0, sk, dv, vec);
  if constexpr (D > 64) {
    dkdv_walk<T, D, true, false>(sm, q, dout, lse, dsum, dk, dvo, b, kv, k0,
                                 sq, sk, kvh, g, dh, dv, causal, prefix_len,
                                 scale, vec);
    dkdv_walk<T, D, false, true>(sm, q, dout, lse, dsum, dk, dvo, b, kv, k0,
                                 sq, sk, kvh, g, dh, dv, causal, prefix_len,
                                 scale, vec);
  } else {
    dkdv_walk<T, D, true, true>(sm, q, dout, lse, dsum, dk, dvo, b, kv, k0,
                                sq, sk, kvh, g, dh, dv, causal, prefix_len,
                                scale, vec);
  }
}

// ---------------------------------------------------------------------------
// 3. dQ per (head, q tile)
// ---------------------------------------------------------------------------
// Shared memory: Q, dO, K, V [BR][D]; Kt [D][BR]; dS [BR][BR]; lse, D.
template <typename T, int D> constexpr int dq_smem() {
  using G = Geo<T>;
  return (4 * G::BR * row_ld<T, D>() + D * G::LT + G::BR * G::LT) *
             (int)sizeof(T) +
         2 * G::BR * (int)sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(Geo<T>::THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dsum, T* __restrict__ dq,
                        int sq, int sk, int kvh, int g, int dh, int dv,
                        int causal, int prefix_len, float scale, int vec) {
  using G = Geo<T>;
  constexpr int BR = G::BR, LD = row_ld<T, D>(), LT = G::LT;
  constexpr int NS = BR / 8, ND = D / 8, KD = D / 16, KS = BR / 16;
  extern __shared__ uint4 smem16[];
  T* Qs = reinterpret_cast<T*>(smem16);
  T* dOs = Qs + BR * LD;
  T* Ks = dOs + BR * LD;
  T* Vs = Ks + BR * LD;
  T* Kt = Vs + BR * LD;
  T* Ps = Kt + D * LT;
  float* ls = reinterpret_cast<float*>(Ps + BR * LT);
  float* ds = ls + BR;

  const int head = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;
  const int b = head / (kvh * g);
  const Head hp = head_of(b, (head / g) % kvh, head % g, sq, sk, kvh, g, dh,
                          dv);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gr = lane >> 2, tq = lane & 3;
  const int row_w = q0 + warp * 16;  // this warp's first row
  const int ksh = (dh + 15) / 16, ksv = (dv + 15) / 16, nth = (dh + 7) / 8;
  T* pw = Ps + warp * 16 * LT;

  stage_rows<T, D>(Qs, q + hp.q_off, hp.q_row, q0, sq, dh, vec);
  stage_rows<T, D>(dOs, dout + hp.o_off, hp.o_row, q0, sq, dv, vec);
  stage_stats<T>(ls, ds, lse + (int64_t)head * sq, dsum + (int64_t)head * sq,
                 q0, sq);
  float acc[ND][4];
  zero(acc);
  const int kv_end = kv_end_of(q0 + BR, sk, causal, prefix_len);
  const int n_tiles = (kv_end + BR - 1) / BR;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BR;
    __syncthreads();  // the previous K, V tiles are consumed
    stage_rows<T, D>(Ks, k + hp.k_off, hp.k_row, k0, sk, dh, vec);
    stage_rows<T, D>(Vs, v + hp.v_off, hp.v_row, k0, sk, dv, vec);
    __syncthreads();
    transpose<T, D>(Kt, Ks);
    __syncthreads();
    if (row_w >= sq ||
        (causal && k0 > row_w + 15 && k0 >= prefix_len))
      continue;
    // S = Q K^T, P; dP = dO V^T; dS = P (dP - D); dQ += dS K.
    float s[NS][4], dp[NS][4];
    zero(s);
    zero(dp);
    mma_acc<NS, KD>(s, Qs + warp * 16 * LD, LD, Ks, LD, NS, ksh);
    mma_acc<NS, KD>(dp, dOs + warp * 16 * LD, LD, Vs, LD, NS, ksv);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * tq + (e & 1);
        const int r = warp * 16 + gr + 8 * (e >> 1);
        const bool ok = q0 + r < sq &&
                        visible(key, q0 + r, sk, causal, prefix_len);
        const float p = ok ? expf(s[j][e] * scale - ls[r]) : 0.f;
        dp[j][e] = p * (dp[j][e] - ds[r]);
      }
    store_tile<T>(pw, LT, dp);
    __syncwarp();
    mma_acc<ND, KS>(acc, pw, LT, Kt, LT, nth, KS);
    __syncwarp();
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_w + gr + 8 * h;
    if (row >= sq) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * tq + e;
        if (col < dh)
          dq[hp.q_off + (int64_t)row * hp.q_row + col] =
              from_f<T>(acc[j][2 * h + e] * scale);
      }
  }
}

template <typename T, typename Kern>
cudaError_t set_smem(Kern kern, int bytes) {
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, void* dq, void* dk,
                   void* dv_out, float* lse, float* dsum, int b, int sq,
                   int sk, int kvh, int g, int dh, int dv, int causal,
                   int prefix_len, float scale, int vec,
                   cudaStream_t stream) {
  using G = Geo<T>;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(o);
  const T* dot = static_cast<const T*>(dout);
  const unsigned heads = (unsigned)(b * kvh * g);
  const unsigned q_tiles = (unsigned)((sq + G::BR - 1) / G::BR);

  auto stats = flash_bwd_stats_kernel<T, D>;
  cudaError_t err = set_smem<T>(stats, stats_smem<T, D>());
  if (err != cudaSuccess) return err;
  stats<<<dim3(heads, q_tiles), G::THREADS, stats_smem<T, D>(), stream>>>(
      qt, kt, ot, dot, lse, dsum, sq, sk, kvh, g, dh, dv, causal, prefix_len,
      scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkdv = flash_bwd_dkdv_kernel<T, D>;
  err = set_smem<T>(dkdv, dkdv_smem<T, D>());
  if (err != cudaSuccess) return err;
  dkdv<<<dim3((unsigned)(b * kvh), (unsigned)((sk + G::BR - 1) / G::BR)),
         G::THREADS, dkdv_smem<T, D>(), stream>>>(
      qt, kt, vt, dot, lse, dsum, static_cast<T*>(dk),
      static_cast<T*>(dv_out), sq, sk, kvh, g, dh, dv, causal, prefix_len,
      scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dqk = flash_bwd_dq_kernel<T, D>;
  err = set_smem<T>(dqk, dq_smem<T, D>());
  if (err != cudaSuccess) return err;
  dqk<<<dim3(heads, q_tiles), G::THREADS, dq_smem<T, D>(), stream>>>(
      qt, kt, vt, dot, lse, dsum, static_cast<T*>(dq), sq, sk, kvh, g, dh, dv,
      causal, prefix_len, scale, vec);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o, dout in the forward's layouts (o: its output, dout: the
// gradient of o), dq, dk, dv the gradients of q, k, v, all contiguous and
// all fp32 or all bf16; lse and dsum fp32 scratch of B*KV*G*Sq floats.
// dh, dv <= 256: the widest of them picks the build (64, 128 or 256
// columns).  prefix_len >= 0 (ignored unless causal); the caller validates
// shapes.  Three launches on `stream`; returns the first CUDA error.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, void* dq, void* dk,
                                   void* dv_out, float* lse, float* dsum,
                                   int b, int sq, int sk, int kvh, int g,
                                   int dh, int dv, int causal, int prefix_len,
                                   int is_bf16, float scale, void* stream) {
  if (dh < 1 || dv < 1 || dh > 256 || dv > 256 || sq < 1 || sk < 1 ||
      b < 1 || kvh < 1 || g < 1 || prefix_len < 0)
    return (int)cudaErrorInvalidValue;
  const int width = max(dh, dv);
  auto s = static_cast<cudaStream_t>(stream);
  const int per16 = is_bf16 ? 8 : 4;
  const uintptr_t bases =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout);
  const int vec = dh % per16 == 0 && dv % per16 == 0 && (bases & 15) == 0;
  auto run = [&](auto kern) {
    return (int)kern(q, k, v, o, dout, dq, dk, dv_out, lse, dsum, b, sq, sk,
                     kvh, g, dh, dv, causal, prefix_len, scale, vec, s);
  };
  if (is_bf16)
    return width > 128  ? run(launch<bf16, 256>)
           : width > 64 ? run(launch<bf16, 128>)
                        : run(launch<bf16, 64>);
  return width > 128  ? run(launch<float, 256>)
         : width > 64 ? run(launch<float, 128>)
                      : run(launch<float, 64>);
}
