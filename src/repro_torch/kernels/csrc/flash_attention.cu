// Flash attention (online softmax) for Hopper, forward only.
//
// Replaces the reference package's TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention (pallas_call body
// _flash_kernel): causal or non-causal attention over the layout
//   q (B, Sq, KV, G, dh), k (B, Sk, KV, dh), v (B, Sk, KV, dv)
//   -> o (B, Sq, KV, G, dv) in q's dtype,
// with fp32 running max m, normaliser l and accumulator acc, keys past Sk
// masked, GQA by grouping, dv != dh and head dims up to 256 allowed.
// Under causal, keys before prefix_len are seen by every row (prefix-LM,
// a VLM's image tokens): the mask of the reference's chunked_attention,
// which its model serves prefix-LM through.
//
// What bounds it on an H100: at the served shapes (Sq = Sk >= 2000,
// dh = 64 or 128) the work is 4·Sq·Sk·dh flops per head (halved when
// causal) against (Sq + 2·Sk)·dh elements moved, so the arithmetic bounds
// it by two orders of magnitude over the bytes: the least time is the
// flops over the tensor cores' bf16 rate.  Three bodies; the wrapper
// (kernels/flash_attention.py, flash_body) picks one from dtype, head dims
// and alignment alone:
//   * flash_fwd_wgmma_kernel, bf16 with (dh, dv) in {(64, 64), (128, 128),
//     (96, 64), (256, 256)} and 16-byte aligned bases (the served heads;
//     (96, 64) is multi-head latent attention's rope 32 + nope 64 against
//     v 64; (256, 256) a VLM's, on 64-key tiles): built for that rate.
//     A ring of K/V tiles is kept in flight with TMA (128-byte swizzle,
//     rows past S zero-filled on load and clipped on store), so loads
//     overlap the math; two warpgroups of 64 q rows each run Q·K^T and
//     P·V on wgmma (operands by shared-memory descriptor, V
//     read through the transpose bit, P from registers), so no thread
//     stages or transposes a tile.  The softmax runs in exp2 with
//     scale·log2(e) folded in, and masks only tiles that straddle the
//     diagonal or Sk.
//   * flash_fwd_mma_kernel, every other bf16 shape (odd or mixed head
//     dims such as (256, 128), misaligned views): mma.sync m16n8k16 with
//     tiles staged by all threads, no pipelining.
//   * flash_fwd_kernel, fp32: fp32 FMAs on the CUDA cores (tensor cores
//     would round the inputs to TF32), so the fp32 results keep fp32
//     products.
// The mma and fp32 bodies are built at 64, 128 and 256 columns; the widest
// head dim picks one.
// All three keep the traffic at the floor:
//   * One block per (head, q tile); a loop inside the block walks the kv
//     tiles (the TPU's sequential kv grid axis), so nothing carries between
//     blocks, which Hopper runs in no order.
//   * The q tile stays on chip for the whole loop; each K and V tile is
//     brought into shared memory once per block.  m, l and acc live in
//     registers; O is written once.
//   * GQA indexes kv head h / G instead of repeating K and V (the TPU
//     wrapper's jnp.repeat), so K and V are read once per group.
//   * Under causal masking the loop stops at the diagonal, or at the
//     prefix's end if that is later: kv tiles wholly above both are never
//     loaded.  Heads run on grid x and q tiles, longest first, on grid y,
//     so the long rows of every head start first.
//   * In bf16, P is rounded to bf16 before P·V, which accumulates in fp32
//     (the reference's p.astype(v.dtype) with preferred_element_type f32).
#include <cuda.h>  // CUtensorMap and its enums; no libcuda at link time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // keys per kv tile
constexpr int kThreads = 128;  // 16 row groups x 8 column groups
constexpr float kNegInf = -1e30f;

// The mask, the reference's chunked_attention's: keys past Sk are never
// seen; under causal a row sees the keys up to itself and, prefix-LM, every
// key before prefix_len (0: none).  q and k both count from position 0.
__device__ __forceinline__ bool visible(int key, int row, int sk, int causal,
                                        int prefix_len) {
  return key < sk && (!causal || key <= row || key < prefix_len);
}

// One past the last key a block of q rows ending before `row_end` reads:
// under causal the keys past its last row are masked, save the prefix's.
__device__ __forceinline__ int kv_end_of(int row_end, int sk, int causal,
                                         int prefix_len) {
  return causal ? max(min(sk, row_end), min(sk, prefix_len)) : sk;
}

// Shared memory, in floats: Q [kBQ][D+4], K [kBK][D+4] (aliased by
// P [kBQ][kBK+4] once the scores are taken), V [kBK][D].
template <int D> constexpr int smem_floats() {
  return kBQ * (D + 4) + kBK * (D + 4) + kBK * D;
}

// Copy rows [row0, row0 + 64) of one head into shared memory, columns
// [0, cols) from global and [cols, D) zero; rows past `rows` zero.
template <int D, int kStride>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      int64_t row_stride, int row0, int rows,
                                      int cols) {
  for (int e = threadIdx.x; e < 64 * D; e += kThreads) {
    const int r = e / D;
    const int d = e - r * D;
    float x = 0.f;
    if (d < cols && row0 + r < rows)
      x = src[(int64_t)(row0 + r) * row_stride + d];
    dst[r * kStride + d] = x;
  }
}

// fp32 kernel: each thread owns 4 q rows x 8 keys of the score tile (keys
// c + 8j, so a quarter-warp reads eight consecutive K rows: conflict-free
// float4 loads) and 4 rows x D/8 columns of acc; row max and sum reduce
// over the 8 threads of a row with warp shuffles.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int sq,
                     int sk, int kvh, int g, int dh, int dv, int causal,
                     int prefix_len, float scale) {
  constexpr int QS = D + 4;    // q / k row stride (floats)
  constexpr int PS = kBK + 4;  // p row stride
  constexpr int NC = D / 32;   // acc column chunks of 32 (4 per thread)
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * QS;
  float* Ps = Ks;  // aliases K: written only after every score is taken
  float* Vs = Ks + kBK * QS;

  const int head = blockIdx.x;  // (b, kv, g) flattened
  const int q_tile = gridDim.y - 1 - blockIdx.y;
  const int q0 = q_tile * kBQ;
  const int b = head / (kvh * g);
  const int kv = (head / g) % kvh;
  const int gi = head % g;

  const int64_t q_row = (int64_t)kvh * g * dh;
  const int64_t o_row = (int64_t)kvh * g * dv;
  const int64_t k_row = (int64_t)kvh * dh;
  const int64_t v_row = (int64_t)kvh * dv;
  const float* qh =
      q + (int64_t)b * sq * q_row + ((int64_t)kv * g + gi) * dh;
  const float* kh = k + (int64_t)b * sk * k_row + (int64_t)kv * dh;
  const float* vh = v + (int64_t)b * sk * v_row + (int64_t)kv * dv;
  float* oh = o + (int64_t)b * sq * o_row + ((int64_t)kv * g + gi) * dv;

  const int tid = threadIdx.x;
  const int rg = tid >> 3;  // rows rg*4 .. rg*4+3
  const int cg = tid & 7;   // keys cg + 8j; acc columns 32c + 4cg .. +3

  stage<D, QS>(Qs, qh, q_row, q0, sq, dh);

  float m[4], l[4], acc[4][NC * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC * 4; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = kv_end_of(q0 + kBQ, sk, causal, prefix_len);
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's P and V are consumed
    stage<D, QS>(Ks, kh, k_row, k0, sk, dh);
    stage<D, D>(Vs, vh, v_row, k0, sk, dv);
    __syncthreads();

    // S = Q K^T for this thread's 4 rows x 8 keys, fp32.
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv4[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(rg * 4 + i) * QS + d]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        kv4[j] =
            *reinterpret_cast<const float4*>(&Ks[(cg + 8 * j) * QS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(qv[i].x, kv4[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv4[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv4[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv4[j].w, s[i][j]);
        }
    }

    // Mask, online softmax update of m, l and acc.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + rg * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool ok =
            visible(k0 + cg + 8 * j, qpos, sk, causal, prefix_len);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool ok =
            visible(k0 + cg + 8 * j, qpos, sk, causal, prefix_len);
        const float p = ok ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        s[i][j] = p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC * 4; ++c) acc[i][c] *= corr;
    }

    __syncthreads();  // every thread is done reading K: P may overwrite it
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        Ps[(rg * 4 + i) * PS + cg + 8 * j] = s[i][j];
    __syncthreads();

    // acc += P V over this tile's keys.
    const int k_live = min(kBK, kv_end - k0);
    for (int kk = 0; kk < k_live; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(rg * 4 + i) * PS + kk]);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c * 32 >= dv) break;
        const float* vp = &Vs[kk * D + c * 32 + cg * 4];
        const float4 v0 = *reinterpret_cast<const float4*>(vp);
        const float4 v1 = *reinterpret_cast<const float4*>(vp + D);
        const float4 v2 = *reinterpret_cast<const float4*>(vp + 2 * D);
        const float4 v3 = *reinterpret_cast<const float4*>(vp + 3 * D);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* a = &acc[i][c * 4];
          a[0] += pv[i].x * v0.x + pv[i].y * v1.x + pv[i].z * v2.x +
                  pv[i].w * v3.x;
          a[1] += pv[i].x * v0.y + pv[i].y * v1.y + pv[i].z * v2.y +
                  pv[i].w * v3.y;
          a[2] += pv[i].x * v0.z + pv[i].y * v1.z + pv[i].z * v2.z +
                  pv[i].w * v3.z;
          a[3] += pv[i].x * v0.w + pv[i].y * v1.w + pv[i].z * v2.w +
                  pv[i].w * v3.w;
        }
      }
    }
  }

  // O = acc / l, written once in q's dtype.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    if (row >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c * 32 + cg * 4 + e;
        if (col < dv)
          oh[(int64_t)row * o_row + col] = acc[i][c * 4 + e] / den;
      }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int sq, int sk, int kvh, int g, int dh, int dv,
                   int causal, int prefix_len, float scale,
                   cudaStream_t stream) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  auto kern = flash_fwd_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(b * kvh * g), (unsigned)((sq + kBQ - 1) / kBQ));
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, sk, kvh, g,
      dh, dv, causal, prefix_len, scale);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16: the products on the tensor cores (mma.sync m16n8k16, fp32 accumulate)
// ---------------------------------------------------------------------------
// Each of the 4 warps owns 16 q rows.  Per 64-key tile a warp takes
// S = Q K^T as 8 n-tiles of 16 x 8 (fp32 in registers), runs the online
// softmax on them, and feeds P back as the A operand of P V without
// leaving registers (the accumulator layout of two adjacent n-tiles is the
// A-operand layout of one 16-key step).  Shared memory holds Q and K
// row-major and V transposed (Vt[d][key]), rows padded by 8 elements so
// that the 32-bit fragment loads of a warp hit 32 distinct banks.
using bf16 = __nv_bfloat16;

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int D> constexpr int mma_smem_bytes() {
  return (kBQ * (D + 8) + kBK * (D + 8) + D * (kBK + 8)) * 2;
}

// Rows [row0, row0 + 64) of one head into dst[r][c] (row stride S), zero
// past `rows` and for c in [cols, D).  `vec`: 16-byte loads (cols % 8 == 0
// and 16-byte aligned rows).
template <int D, int S>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           int64_t row_stride, int row0,
                                           int rows, int cols, bool vec) {
  if (vec) {
    constexpr int CH = D / 8;
    for (int e = threadIdx.x; e < 64 * CH; e += kThreads) {
      const int r = e / CH;
      const int c = (e - r * CH) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (c < cols && row0 + r < rows)
        x = *reinterpret_cast<const uint4*>(
            src + (int64_t)(row0 + r) * row_stride + c);
      *reinterpret_cast<uint4*>(dst + r * S + c) = x;
    }
    return;
  }
  for (int e = threadIdx.x; e < 64 * D; e += kThreads) {
    const int r = e / D;
    const int c = e - r * D;
    bf16 x = __float2bfloat16(0.f);
    if (c < cols && row0 + r < rows)
      x = src[(int64_t)(row0 + r) * row_stride + c];
    dst[r * S + c] = x;
  }
}

// V rows [row0, row0 + 64) transposed into dst[c][r] (row stride S).
template <int D, int S>
__device__ __forceinline__ void stage_cols(bf16* dst, const bf16* src,
                                           int64_t row_stride, int row0,
                                           int rows, int cols, bool vec) {
  if (vec) {
    constexpr int CH = D / 8;
    for (int e = threadIdx.x; e < 64 * CH; e += kThreads) {
      const int r = e % 64;  // neighbouring threads: neighbouring keys
      const int c = (e / 64) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (c < cols && row0 + r < rows)
        x = *reinterpret_cast<const uint4*>(
            src + (int64_t)(row0 + r) * row_stride + c);
      const bf16* xs = reinterpret_cast<const bf16*>(&x);
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[(c + i) * S + r] = xs[i];
    }
    return;
  }
  for (int e = threadIdx.x; e < 64 * D; e += kThreads) {
    const int r = e % 64;
    const int c = e / 64;
    bf16 x = __float2bfloat16(0.f);
    if (c < cols && row0 + r < rows)
      x = src[(int64_t)(row0 + r) * row_stride + c];
    dst[c * S + r] = x;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         int sq, int sk, int kvh, int g, int dh, int dv,
                         int causal, int prefix_len, float scale, int vec) {
  constexpr int QS = D + 8;    // Q / K row stride (elements)
  constexpr int VS = kBK + 8;  // Vt row stride
  constexpr int KD = D / 16;   // 16-wide steps over the head dim
  constexpr int NV = D / 8;    // 8-wide output column tiles
  extern __shared__ uint4 smem16[];
  bf16* Qs = reinterpret_cast<bf16*>(smem16);
  bf16* Ks = Qs + kBQ * QS;
  bf16* Vt = Ks + kBK * QS;

  const int head = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int b = head / (kvh * g);
  const int kv = (head / g) % kvh;
  const int gi = head % g;
  const int64_t q_row = (int64_t)kvh * g * dh;
  const int64_t o_row = (int64_t)kvh * g * dv;
  const int64_t k_row = (int64_t)kvh * dh;
  const int64_t v_row = (int64_t)kvh * dv;
  const bf16* qh = q + (int64_t)b * sq * q_row + ((int64_t)kv * g + gi) * dh;
  const bf16* kh = k + (int64_t)b * sk * k_row + (int64_t)kv * dh;
  const bf16* vh = v + (int64_t)b * sk * v_row + (int64_t)kv * dv;
  bf16* oh = o + (int64_t)b * sq * o_row + ((int64_t)kv * g + gi) * dv;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gr = lane >> 2;  // fragment row (and row + 8)
  const int tq = lane & 3;   // fragment column pair 2tq, 2tq + 1
  const int row0 = q0 + warp * 16 + gr;  // this thread's rows: row0, +8

  stage_rows<D, QS>(Qs, qh, q_row, q0, sq, dh, vec);
  __syncthreads();
  // This warp's Q fragments are read again from Qs (which no tile
  // overwrites) at each step kk of 16 columns.  Holding them across the
  // loop takes D / 4 registers a thread: at 256 they do not fit beside
  // acc, and at 128 they cost a block an SM and the body ran slower; at 64
  // they gained a few percent (variant "Q held" of tools/flash_variants.py
  // --body mma; PERF.md section 6).

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[NV][4];
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int kv_end = kv_end_of(q0 + kBQ, sk, causal, prefix_len);
  const int n_tiles = (kv_end + kBK - 1) / kBK;
  const int warp_last_row = q0 + warp * 16 + 15;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's K and V are consumed
    stage_rows<D, QS>(Ks, kh, k_row, k0, sk, dh, vec);
    stage_cols<D, VS>(Vt, vh, v_row, k0, sk, dv, vec);
    __syncthreads();
    // A tile wholly above this warp's rows and past the prefix changes
    // nothing: skip it.
    if (causal && k0 > warp_last_row && k0 >= prefix_len) continue;

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const bf16* qp = Qs + (warp * 16 + gr) * QS + kk * 16 + 2 * tq;
      const uint32_t a[4] = {ld32(qp), ld32(qp + 8 * QS), ld32(qp + 8),
                             ld32(qp + 8 * QS + 8)};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bf16* kp = Ks + (j * 8 + gr) * QS + kk * 16 + 2 * tq;
        mma_bf16(s[j], a, ld32(kp), ld32(kp + 8));
      }
    }

    // Mask and online softmax; element e of n-tile j is row row0 + 8*(e/2),
    // key k0 + 8j + 2tq + (e & 1).
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * tq + (e & 1);
        const int row = row0 + 8 * (e >> 1);
        const bool ok = visible(key, row, sk, causal, prefix_len);
        s[j][e] = ok ? s[j][e] * scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float corr[2], m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      m_new[h] = fmaxf(m[h], mx[h]);
      corr[h] = expf(m[h] - m_new[h]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * tq + (e & 1);
        const int row = row0 + 8 * (e >> 1);
        const bool ok = visible(key, row, sk, causal, prefix_len);
        const float p = ok ? expf(s[j][e] - m_new[e >> 1]) : 0.f;
        sum[e >> 1] += p;
        s[j][e] = p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = l[h] * corr[h] + sum[h];
      m[h] = m_new[h];
    }
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // acc += P V: P rounded to bf16 (the reference's p.astype(v.dtype)).
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        if (n * 8 >= dv) break;
        const bf16* vp = Vt + (n * 8 + gr) * VS + kk * 16 + 2 * tq;
        mma_bf16(acc[n], a, ld32(vp), ld32(vp + 8));
      }
    }
  }

  // O = acc / l, written once.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= sq) continue;
    const float den = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * tq + e;
        if (col < dv)
          oh[(int64_t)row * o_row + col] =
              __float2bfloat16(acc[n][2 * h + e] / den);
      }
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       int b, int sq, int sk, int kvh, int g, int dh, int dv,
                       int causal, int prefix_len, float scale, int vec,
                       cudaStream_t stream) {
  const int smem = mma_smem_bytes<D>();
  auto kern = flash_fwd_mma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(b * kvh * g), (unsigned)((sq + kBQ - 1) / kBQ));
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), sq, sk, kvh, g, dh,
      dv, causal, prefix_len, scale, vec);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16 on Hopper: a TMA-fed K/V ring and wgmma
// ---------------------------------------------------------------------------
// One block per (head, 128-row q tile): two consumer warpgroups of 64 q
// rows each.  The q tile and a ring of (K tile, V tile) stages come in by
// TMA, each stage counted on a `full` mbarrier (TMA's byte count) and
// released by every consumer warp after its last read of it.  Who refills
// a stage is the pair's `WgCfg::PRODUCER`:
//   * up to 128 columns, a producer warpgroup ahead of the consumers: one
//     of its threads waits on each stage's `empty` mbarrier and issues the
//     copies, and `setmaxnreg` gives the consumers its registers;
//   * at DV = 256, no producer: each warp adds one to the stage's release
//     count, and the warp that completes it issues the copies of the tile
//     the stage takes next.  ptxas compiles a kernel under one register
//     budget, that of the SM sub-partition holding the most of the
//     block's warps (`setmaxnreg` moves registers at run time, but ptxas
//     allocates the consumers' code within the launch bound all the
//     same): 12 warps, or 9, leave 168 registers a thread, under which
//     O (128 registers at 256 columns), S and P spilled and ptxas
//     serialised the wgmma; 8 warps leave 255.  The pairs up to 128
//     columns fit 168, and without the producer they ran 2-11% slower
//     (tools/flash_variants.py).
// Each consumer skips the products of a tile none of its rows sees (and
// every tile, if its rows all lie past Sq), still waiting on and
// releasing it: S = Q K^T on wgmma with both operands read from shared
// memory by descriptor, online softmax on S in registers, then O += P V
// on wgmma with P (bf16) taken from registers in the accumulator's own
// layout and V read as TMA left it (keys x dv, dv contiguous: the
// descriptor's transpose bit).  Every
// tile lands with 128-byte swizzle in boxes of 64 columns (128 bytes); a
// head dim of 128 is two boxes side by side, each its own [rows][64]
// block in shared memory.  Rows past S are zero on load and clipped on
// store by TMA.
// The Q·K side (q, k: DH columns) and the P·V side (v, o: DV columns)
// have their own boxes.  A DH that is no multiple of 64 (MLA's 96) takes
// whole boxes too: the last box runs past the map's DH columns, TMA fills
// the rest with zeros (and counts the whole box's bytes on the barrier),
// and Q·K's DH/16 steps never read them.
constexpr int kWgBQ = 128;       // q rows per block: 64 per consumer
constexpr int kWgWarps = 8;      // the consumers' warps: 2 warpgroups
constexpr int kBoxCols = 64;     // bf16 per 128-byte swizzled box row
constexpr int kRowBytes = 128;
constexpr int kQBoxRows = 64;    // q and o boxes: one consumer's rows
constexpr int kMaxSmem = 232448;  // a block's opt-in shared memory

template <int DH, int DV> struct WgCfg {
  // Keys per kv tile and ring depth.  A consumer thread holds O (DV/2
  // floats), S (BK/2) and P (BK/4 words) at once: at DV = 256 O alone is
  // 128 registers, so its tiles are 64 keys, and a stage of K and V at
  // 256 columns (64 KB) leaves room for two beside the 64 KB q tile.  The
  // other pairs take 128 keys and three stages, what (128, 128) fits;
  // (96, 64) would take four (230,528 bytes), which a source variant
  // times (tools/flash_variants.py).
  static constexpr int BK = DV == 256 ? 64 : 128;
  static constexpr int STAGES = DV == 256 ? 2 : 3;
  // A producer warpgroup refills the ring (above).
  static constexpr bool PRODUCER = DV <= 128;
  static constexpr int THREADS = 32 * kWgWarps + 128 * PRODUCER;
  static constexpr int CBK = (DH + kBoxCols - 1) / kBoxCols;  // q, k boxes
  static constexpr int CBV = DV / kBoxCols;                   // v, o boxes
  static constexpr int Q_BYTES = kWgBQ * CBK * kRowBytes;
  static constexpr int K_BYTES = BK * CBK * kRowBytes;  // one K tile
  static constexpr int V_BYTES = BK * CBV * kRowBytes;  // one V tile
  static constexpr int STAGE_BYTES = K_BYTES + V_BYTES;
  static constexpr int DATA_BYTES = Q_BYTES + STAGES * STAGE_BYTES;
  // + the mbarriers (q, full[STAGES]), each stage's release (an `empty`
  // mbarrier or a count; 8 bytes) and room to align
  // the base to the 1024 bytes the swizzle pattern repeats over.
  static constexpr int SMEM_BYTES = 1024 + DATA_BYTES + 128;
  static_assert(DH % 16 == 0 && DV % kBoxCols == 0,
                "Q K^T steps 16 columns; P V takes whole boxes");
  // O is staged in the consumer's dead q rows, box for box.
  static_assert(CBV <= CBK, "O's boxes fit in Q's");
  static_assert(SMEM_BYTES <= kMaxSmem, "the ring fits a block");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Arrives on `bar` and adds `bytes` to the transaction count it awaits.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the phase of `bar` with this parity to complete.  A wait past
// any real one (2^34 cycles, seconds) traps, so a lost TMA transaction
// shows as a launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// One box of a rank-4 map, coordinates innermost first, into shared memory;
// completion counts its bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// 2^x on the special-function unit (relative error about 2^-22; -inf
// gives 0).  exp2f would add a range fix-up around it on every score.
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// wgmma shared-memory descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers at this point of the instruction stream: what wgmma
// writes asynchronously is read only after the wait, and what the threads
// write is in place before the fence.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D (64 x 128, fp32) = A (64 x 16, smem) B^T (128 x 16, smem, K-major)
// (+ D when scale_d).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, fp32) = A (64 x 16, smem) B^T (64 x 16, smem, K-major)
// (+ D when scale_d).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}

// D (64 x 64, fp32) += A (64 x 16, registers) B (16 x 64, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, registers) B (16 x 128, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 256, fp32) += A (64 x 16, registers) B (16 x 256, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99,"
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110,"
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121,"
      "%122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

// S = Q K^T for one consumer: 64 q rows x BK keys, DH/16 steps of 16
// columns; a step's 32 bytes advance the descriptor inside its 128-byte
// swizzled row, and every 64 columns move to the next column box.
template <int DH, int BK>
__device__ __forceinline__ void qk_issue(float (&sc)[BK / 2], uint32_t sQw,
                                         uint32_t ks) {
  static_assert(BK == 64 || BK == 128,
                "S is one m64n64k16 or m64n128k16 product per 16 columns");
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int c = kk / 4;                // column box
    const uint32_t off = (kk % 4) * 32;  // 16 columns in it
    wgmma_ss<BK>(sc, smem_desc(sQw + c * kWgBQ * kRowBytes + off, 16, 1024),
                 smem_desc(ks + c * BK * kRowBytes + off, 16, 1024), kk > 0);
  }
}

// O += P V for one consumer: BK/16 steps of 16 keys (16 rows of the V
// tile, 2048 bytes); V is keys x dv with dv contiguous (MN-major, the
// transpose bit), column boxes BK rows apart (the leading byte offset),
// one product across all DV columns (m64n256k16 at 256).
template <int DV, int BK>
__device__ __forceinline__ void pv_issue(float (&o)[DV / 2],
                                         const uint32_t (&pa)[BK / 16][4],
                                         uint32_t vs) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs<DV>(o, pa[kk],
                smem_desc(vs + kk * 16 * kRowBytes, BK * kRowBytes, 1024));
}

// One online-softmax step on an S tile in the wgmma accumulator layout,
// in place (S becomes P in fp32): element e of n-tile j is row
// my_row + 8·(e >> 1), key k0 + 8j + 2·(lane % 4) + (e & 1).  Updates m
// and this thread's share of l, and returns O's rescale factor per row.
template <int NS>
__device__ __forceinline__ void softmax_step(float (&sc)[NS], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             bool mask, int k0, int sk,
                                             int causal, int prefix_len,
                                             int my_row, int lane,
                                             float scale_log2) {
  if (mask) {
#pragma unroll
    for (int j = 0; j < NS / 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
        const int row = my_row + 8 * (e >> 1);
        if (!visible(key, row, sk, causal, prefix_len))
          sc[4 * j + e] = -INFINITY;
      }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < NS; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  float neg_m[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h] * scale_log2);
    // A row with no live key yet keeps m = -inf: subtract 0 instead.
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    corr[h] = exp2_fast(m[h] - m_use);
    neg_m[h] = -m_use;
    m[h] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    sc[i] = exp2_fast(fmaf(sc[i], scale_log2, neg_m[(i >> 1) & 1]));
    sum[(i >> 1) & 1] += sc[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + sum[h];
}

// P rounded to bf16 (the reference's p.astype(v.dtype)) as P·V's A
// operand: 16 keys are n-tiles 2kk and 2kk + 1 of S.
template <int NS>
__device__ __forceinline__ void to_bf16(const float (&sc)[NS],
                                        uint32_t (&pa)[NS / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < NS / 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
}

// `heads` = KV·G q heads; grid x = B·heads, grid y = q tiles (longest
// causal rows first).  scale_log2 = scale·log2(e): p = 2^(dot·scale_log2 -
// m) with m the running row max of dot·scale_log2.
template <int DH, int DV>
__global__ void __launch_bounds__(WgCfg<DH, DV>::THREADS, 1)
    flash_fwd_wgmma_kernel(__grid_constant__ const CUtensorMap tq,
                           __grid_constant__ const CUtensorMap tk,
                           __grid_constant__ const CUtensorMap tv,
                           __grid_constant__ const CUtensorMap to, int sq,
                           int sk, int heads, int g, int causal,
                           int prefix_len, float scale_log2) {
  using C = WgCfg<DH, DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;  // [CBK][kWgBQ rows][128 B]
  // Stage s: K [CBK][BK][128 B], then V [CBV][BK][128 B].
  const uint32_t sKV = base + C::Q_BYTES;
  const uint32_t q_bar = base + C::DATA_BYTES;
  const uint32_t full_bar = q_bar + 8;
  // Stage s's release: an `empty` mbarrier with a producer, a count of
  // released warps without.
  const uint32_t release_at = full_bar + 8 * C::STAGES;

  const int hq = blockIdx.x % heads;  // q head in the flattened KV·G axis
  const int b = blockIdx.x / heads;
  const int kv = hq / g;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWgBQ;
  const int kv_end = kv_end_of(q0 + kWgBQ, sk, causal, prefix_len);
  const int n_tiles = (kv_end + C::BK - 1) / C::BK;
  const int wg = threadIdx.x / 128;  // (the producer), then the consumers
  const int tw = threadIdx.x % 128;

  // The q tile; tile t's K and V into its stage.  One thread issues every
  // copy, counted on the tile's barrier.
  auto load_q = [&]() {
    mbar_expect_tx(q_bar, C::Q_BYTES);
    for (int w = 0; w < 2; ++w)
      for (int c = 0; c < C::CBK; ++c)
        tma_load(sQ + (c * kWgBQ + kQBoxRows * w) * kRowBytes, &tq, q_bar,
                 c * kBoxCols, hq, q0 + kQBoxRows * w, b);
  };
  auto load = [&](int t) {
    const int s = t % C::STAGES;
    const uint32_t ks = sKV + s * C::STAGE_BYTES;
    mbar_expect_tx(full_bar + 8 * s, C::STAGE_BYTES);
    for (int c = 0; c < C::CBK; ++c)
      tma_load(ks + c * C::BK * kRowBytes, &tk, full_bar + 8 * s,
               c * kBoxCols, kv, t * C::BK, b);
    for (int c = 0; c < C::CBV; ++c)
      tma_load(ks + C::K_BYTES + c * C::BK * kRowBytes, &tv,
               full_bar + 8 * s, c * kBoxCols, kv, t * C::BK, b);
  };
  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      if constexpr (C::PRODUCER)
        mbar_init(release_at + 8 * s, kWgWarps);  // one arrival a warp
      else
        asm volatile("st.shared.u32 [%0], 0;\n" ::"r"(release_at + 8 * s)
                     : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if constexpr (C::PRODUCER) {
    if (wg == 0) {
      // The producer: one thread issues every copy.  The block holds
      // 384 x 168 registers; the producer gives back 128 x (168 - 40),
      // which is what the consumers take (256 x (232 - 168)).
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
      if (tw == 0) {
        load_q();
        for (int t = 0; t < n_tiles; ++t) {
          // A fresh barrier passes the wait on parity 1: the first lap of
          // the ring finds every stage free.
          mbar_wait(release_at + 8 * (t % C::STAGES),
                    ((t / C::STAGES) & 1) ^ 1);
          load(t);
        }
      }
      return;
    }
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  } else if (threadIdx.x == 0) {
    load_q();
    for (int t = 0; t < min(C::STAGES, n_tiles); ++t) load(t);
  }

  // A consumer: 64 q rows; warp w of it holds rows 16w + lane/4 (+ 8).
  // Each consumer runs S = Q K^T, the softmax and O += P V of a tile in
  // turn; the two consumers overlap each other's softmax with their
  // products on the tensor cores.
  constexpr int NS = C::BK / 2;  // S: BK/8 n-tiles of 4 floats
  constexpr int NO = DV / 2;     // O: DV/8 n-tiles of 4 floats
  const int cw = wg - C::PRODUCER;
  const int warp = tw / 32, lane = tw % 32;
  const int row0 = q0 + kQBoxRows * cw;            // this consumer's rows:
  const int my_row = row0 + 16 * warp + lane / 4;  // this thread's, and + 8
  const uint32_t sQw = sQ + kQBoxRows * cw * kRowBytes;
  auto stage = [&](int t) { return sKV + (t % C::STAGES) * C::STAGE_BYTES; };
  auto wait_full = [&](int t) {
    mbar_wait(full_bar + 8 * (t % C::STAGES), (t / C::STAGES) & 1);
  };
  // Each consumer warp releases a stage after its last read of it.
  // Without a producer, the last of the block's warps to count itself out
  // refills the stage with tile t + STAGES (the count only grows: every
  // lap adds one a warp).
  auto release = [&](int t) {
    __syncwarp();
    if (lane != 0) return;
    const uint32_t at = release_at + 8 * (t % C::STAGES);
    if constexpr (C::PRODUCER) {
      mbar_arrive(at);
    } else {
      uint32_t n;
      asm volatile("atom.acq_rel.cta.shared::cta.add.u32 %0, [%1], 1;\n"
                   : "=r"(n)
                   : "r"(at)
                   : "memory");
      if (n % kWgWarps == kWgWarps - 1 && t + C::STAGES < n_tiles)
        load(t + C::STAGES);
    }
  };
  // Only tiles that straddle Sk, or under causal the diagonal and the
  // prefix's end, are masked: a tile is whole when its last key is at or
  // before this consumer's first row, or before prefix_len.
  auto edge = [&](int t) {
    const int end = (t + 1) * C::BK;
    return end > sk || (causal && end - 1 > row0 && end > prefix_len);
  };
  // A tile holds a key this consumer's rows see unless they all lie at or
  // past Sq, or (causal) its first key lies past their last row and at or
  // past prefix_len.  Tiles the block loads for the other consumer only
  // come with 64-key tiles (the second consumer's diagonal) and with rows
  // past Sq; their products are skipped, the tile still waited on and
  // released.
  auto seen = [&](int t) {
    const int k0 = t * C::BK;
    return row0 < sq &&
           !(causal && k0 > row0 + kQBoxRows - 1 && k0 >= prefix_len);
  };

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  // m: running max of dot·scale_log2; l: this thread's share of the row
  // sum (the 4 threads of a row add theirs at the end).
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  mbar_wait(q_bar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    wait_full(t);
    if (seen(t)) {
      float sc[NS], corr[2];
      wgmma_fence();
      qk_issue<DH, C::BK>(sc, sQw, stage(t));
      wgmma_commit();
      wgmma_wait<0>();
      pin(sc);
      softmax_step(sc, m, l, corr, edge(t), t * C::BK, sk, causal,
                   prefix_len, my_row, lane, scale_log2);
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] *= corr[(i >> 1) & 1];
      uint32_t pa[C::BK / 16][4];
      to_bf16(sc, pa);
      pin(o);
      pin(pa);
      wgmma_fence();
      pv_issue<DV, C::BK>(o, pa, stage(t) + C::K_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      pin(o);
    }
    release(t);
  }
  if (row0 >= sq) return;  // rows all past Sq: nothing to store

  // O = acc / l in bf16, staged in this consumer's (now dead) q rows with
  // the map's swizzle, then one TMA store per column box.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < NO / 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + lane / 4 + 8 * h;
      const uint32_t addr = sQw + (j / 8) * kWgBQ * kRowBytes +
                            r * kRowBytes + (((j % 8) ^ (r % 8)) << 4) +
                            (lane % 4) * 4;
      const uint32_t val =
          pack_bf16(o[4 * j + 2 * h] / l[h], o[4 * j + 2 * h + 1] / l[h]);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(val)
                   : "memory");
    }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
  if (tw == 0) {
    for (int c = 0; c < C::CBV; ++c)
      tma_store(&to, sQw + c * kWgBQ * kRowBytes, c * kBoxCols, hq, row0, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time through the runtime's
// entry-point query, so the library links no libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <int DH, int DV>
int launch_wgmma(const void* const ptrs[4], const long long* dims,
                 const long long* strides, const int* boxes, int qk_boxes,
                 int vo_boxes, int b, int sq, int sk, int heads, int g,
                 int causal, int prefix_len, float scale,
                 cudaStream_t stream) {
  using C = WgCfg<DH, DV>;
  // The maps' geometry comes from the caller; the boxes must be the tiles
  // this build was compiled for, and the column dims its head dims: q, k
  // (DH), v, o (DV) in that order.
  const int box_rows[4] = {kQBoxRows, C::BK, C::BK, kQBoxRows};
  const int cols[4] = {DH, DH, DV, DV};
  if (qk_boxes != C::CBK || vo_boxes != C::CBV)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 4; ++i)
    if (boxes[4 * i] != kBoxCols || boxes[4 * i + 1] != 1 ||
        boxes[4 * i + 2] != box_rows[i] || boxes[4 * i + 3] != 1 ||
        dims[4 * i] != cols[i])
      return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i) {
    cuuint64_t gdim[4], gstride[3];
    cuuint32_t box[4], estride[4] = {1, 1, 1, 1};
    for (int j = 0; j < 4; ++j) {
      gdim[j] = (cuuint64_t)dims[4 * i + j];
      box[j] = (cuuint32_t)boxes[4 * i + j];
    }
    for (int j = 0; j < 3; ++j) gstride[j] = (cuuint64_t)strides[3 * i + j];
    const CUresult r = encode(
        &maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
        const_cast<void*>(ptrs[i]), gdim, gstride, box, estride,
        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return -(int)r;  // the CUresult, negated
  }
  auto kern = flash_fwd_wgmma_kernel<DH, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(b * heads), (unsigned)((sq + kWgBQ - 1) / kWgBQ));
  kern<<<grid, C::THREADS, C::SMEM_BYTES, stream>>>(
      maps[0], maps[1], maps[2], maps[3], sq, sk, heads, g, causal,
      prefix_len, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: contiguous, in the layouts above, all fp32 or all bf16.
// dh, dv <= 256: the widest of them picks the build (64, 128 or 256
// columns).  prefix_len >= 0 (ignored unless causal); the caller
// validates shapes.  Returns the CUDA status.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int b, int sq,
                                   int sk, int kvh, int g, int dh, int dv,
                                   int causal, int prefix_len, int is_bf16,
                                   float scale, void* stream) {
  if (dh < 1 || dv < 1 || dh > 256 || dv > 256 || sq < 1 || sk < 1 ||
      prefix_len < 0)
    return (int)cudaErrorInvalidValue;
  const int width = max(dh, dv);
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const int vec =
        dh % 8 == 0 && dv % 8 == 0 &&
        ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
          reinterpret_cast<uintptr_t>(v)) & 15) == 0;
    auto run = [&](auto kern) {
      return kern(q, k, v, o, b, sq, sk, kvh, g, dh, dv, causal, prefix_len,
                  scale, vec, s);
    };
    return (int)(width > 128 ? run(launch_mma<256>)
                 : width > 64 ? run(launch_mma<128>)
                              : run(launch_mma<64>));
  }
  auto run = [&](auto kern) {
    return kern(q, k, v, o, b, sq, sk, kvh, g, dh, dv, causal, prefix_len,
                scale, s);
  };
  return (int)(width > 128 ? run(launch<256>)
               : width > 64 ? run(launch<128>)
                            : run(launch<64>));
}

// The Hopper bf16 body: q, k, v, o contiguous bf16 in the layouts above,
// (dh, dv) in {(64, 64), (128, 128), (96, 64), (256, 256)},
// 16-byte-aligned bases; prefix_len >= 0 as flash_attention_fwd's.
// dims, strides and boxes describe the rank-4 maps of q, k, v and o in
// that order (4 dims innermost first, the byte strides of dims 1-3, 4 box
// dims each; k and v boxes span the pair's key tile, WgCfg::BK rows);
// qk_boxes and vo_boxes are the 64-column boxes across dh and across dv.
// Returns the CUDA status, or minus the CUresult if a map cannot be
// encoded.
extern "C" int flash_attention_fwd_wgmma(const void* q, const void* k,
                                         const void* v, void* o,
                                         const long long* dims,
                                         const long long* strides,
                                         const int* boxes, int qk_boxes,
                                         int vo_boxes, int b, int sq, int sk,
                                         int heads, int g, int dh, int dv,
                                         int causal, int prefix_len,
                                         float scale, void* stream) {
  if (sq < 1 || sk < 1 || b < 1 || heads < 1 || g < 1 || heads % g != 0 ||
      prefix_len < 0)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[4] = {q, k, v, o};
  auto s = static_cast<cudaStream_t>(stream);
  if (dh == 64 && dv == 64)
    return launch_wgmma<64, 64>(ptrs, dims, strides, boxes, qk_boxes,
                                vo_boxes, b, sq, sk, heads, g, causal,
                                prefix_len, scale, s);
  if (dh == 128 && dv == 128)
    return launch_wgmma<128, 128>(ptrs, dims, strides, boxes, qk_boxes,
                                  vo_boxes, b, sq, sk, heads, g, causal,
                                  prefix_len, scale, s);
  if (dh == 96 && dv == 64)
    return launch_wgmma<96, 64>(ptrs, dims, strides, boxes, qk_boxes,
                                vo_boxes, b, sq, sk, heads, g, causal,
                                prefix_len, scale, s);
  if (dh == 256 && dv == 256)
    return launch_wgmma<256, 256>(ptrs, dims, strides, boxes, qk_boxes,
                                  vo_boxes, b, sq, sk, heads, g, causal,
                                  prefix_len, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the wgmma body at head dims (dh, dv) (0 if it
// is not built for them).
extern "C" int flash_attention_wgmma_smem_bytes(int dh, int dv) {
  return dh == 64 && dv == 64     ? WgCfg<64, 64>::SMEM_BYTES
         : dh == 128 && dv == 128 ? WgCfg<128, 128>::SMEM_BYTES
         : dh == 96 && dv == 64   ? WgCfg<96, 64>::SMEM_BYTES
         : dh == 256 && dv == 256 ? WgCfg<256, 256>::SMEM_BYTES
                                  : 0;
}
