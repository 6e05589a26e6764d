// Flash attention (online softmax) for Hopper, forward only.
//
// Replaces the reference package's TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention (pallas_call body
// _flash_kernel): causal or non-causal attention over the layout
//   q (B, Sq, KV, G, dh), k (B, Sk, KV, dh), v (B, Sk, KV, dv)
//   -> o (B, Sq, KV, G, dv) in q's dtype,
// with fp32 running max m, normaliser l and accumulator acc, keys past Sk
// masked, GQA by grouping and dv != dh allowed.
//
// What bounds it on an H100: at the served shapes (Sq = Sk >= 2000,
// dh = 64) the work is 4·Sq·Sk·dh flops per head (halved when causal)
// against (Sq + 2·Sk)·dh elements moved, so the arithmetic bounds it by
// two orders of magnitude over the bytes: the least time is the flops over
// the tensor cores' bf16 rate.  Two kernels share one design:
//   * bf16 (the served path): Q·K^T and P·V on the tensor cores with
//     mma.sync m16n8k16 (fp32 accumulate), S and P never leaving registers;
//     no TMA, wgmma or software pipelining yet.
//   * fp32: fp32 FMAs on the CUDA cores (tensor cores would round the
//     inputs to TF32), so the fp32 results keep fp32 products.
// The shared design keeps the traffic at the floor:
//   * One block per (head, 64-row q tile); a loop inside the block walks
//     the kv tiles (the TPU's sequential kv grid axis), so nothing carries
//     between blocks, which Hopper runs in no order.
//   * The q tile stays on chip for the whole loop; each 64-key K and V
//     tile is staged in shared memory once per block and read by all of
//     its 128 threads.  m, l and acc live in registers; O is written once.
//   * GQA indexes kv head h / G instead of repeating K and V (the TPU
//     wrapper's jnp.repeat), so K and V are read once per group.
//   * Under causal masking the loop stops at the diagonal: kv tiles wholly
//     above it are never loaded.  Heads run on grid x and q tiles, longest
//     first, on grid y, so the long rows of every head start first.
//   * In bf16, P is rounded to bf16 before P·V, which accumulates in fp32
//     (the reference's p.astype(v.dtype) with preferred_element_type f32).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // keys per kv tile
constexpr int kThreads = 128;  // 16 row groups x 8 column groups
constexpr float kNegInf = -1e30f;

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
                     float scale) {
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

  // Keys past the last row of this tile are all masked under causal.
  const int kv_end = causal ? min(sk, q0 + kBQ) : sk;
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
        const int kpos = k0 + cg + 8 * j;
        const bool ok = kpos < sk && (!causal || kpos <= qpos);
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
        const int kpos = k0 + cg + 8 * j;
        const bool ok = kpos < sk && (!causal || kpos <= qpos);
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
                   int causal, float scale, cudaStream_t stream) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  auto kern = flash_fwd_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(b * kvh * g), (unsigned)((sq + kBQ - 1) / kBQ));
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, sk, kvh, g,
      dh, dv, causal, scale);
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
                         int causal, float scale, int vec) {
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
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const bf16* qp = Qs + (warp * 16 + gr) * QS + kk * 16 + 2 * tq;
    qf[kk][0] = ld32(qp);
    qf[kk][1] = ld32(qp + 8 * QS);
    qf[kk][2] = ld32(qp + 8);
    qf[kk][3] = ld32(qp + 8 * QS + 8);
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[NV][4];
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int kv_end = causal ? min(sk, q0 + kBQ) : sk;
  const int n_tiles = (kv_end + kBK - 1) / kBK;
  const int warp_last_row = q0 + warp * 16 + 15;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's K and V are consumed
    stage_rows<D, QS>(Ks, kh, k_row, k0, sk, dh, vec);
    stage_cols<D, VS>(Vt, vh, v_row, k0, sk, dv, vec);
    __syncthreads();
    // A tile wholly above this warp's rows changes nothing: skip it.
    if (causal && k0 > warp_last_row) continue;

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bf16* kp = Ks + (j * 8 + gr) * QS + kk * 16 + 2 * tq;
        mma_bf16(s[j], qf[kk], ld32(kp), ld32(kp + 8));
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
        const bool ok = key < sk && (!causal || key <= row);
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
        const bool ok = key < sk && (!causal || key <= row);
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
                       int causal, float scale, int vec, cudaStream_t stream) {
  const int smem = mma_smem_bytes<D>();
  auto kern = flash_fwd_mma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(b * kvh * g), (unsigned)((sq + kBQ - 1) / kBQ));
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), sq, sk, kvh, g, dh,
      dv, causal, scale, vec);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: contiguous, in the layouts above, all fp32 or all bf16.
// dh, dv <= 128; the caller validates shapes.  Returns the CUDA status.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int b, int sq,
                                   int sk, int kvh, int g, int dh, int dv,
                                   int causal, int is_bf16, float scale,
                                   void* stream) {
  if (dh < 1 || dv < 1 || dh > 128 || dv > 128 || sq < 1 || sk < 1)
    return (int)cudaErrorInvalidValue;
  const bool wide = dh > 64 || dv > 64;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    const bool vec =
        dh % 8 == 0 && dv % 8 == 0 &&
        ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
          reinterpret_cast<uintptr_t>(v)) & 15) == 0;
    err = wide ? launch_mma<128>(q, k, v, o, b, sq, sk, kvh, g, dh, dv,
                                 causal, scale, vec, s)
               : launch_mma<64>(q, k, v, o, b, sq, sk, kvh, g, dh, dv,
                                causal, scale, vec, s);
  } else {
    err = wide ? launch<128>(q, k, v, o, b, sq, sk, kvh, g, dh, dv, causal,
                             scale, s)
               : launch<64>(q, k, v, o, b, sq, sk, kvh, g, dh, dv, causal,
                            scale, s);
  }
  return (int)err;
}
