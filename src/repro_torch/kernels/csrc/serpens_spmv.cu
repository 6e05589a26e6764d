// Serpens stream SpMV / SpMM and the fused solver step, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernels of the JAX reference package:
//   src/repro/kernels/serpens_spmv.py::spmv_pallas (body _spmv_kernel)
//   src/repro/kernels/serpens_spmv.py::spmm_pallas (body _spmm_kernel)
//   src/repro/kernels/serpens_spmv.py::spmv_fused_pallas (inner kernel)
//
// What they compute.  The stream is T tiles of (SUB, LANES) slots.  Slot
// (t, s, l) holds a packed int32 word w = (row_local << 16) | col_local
// (w == -1 is an empty slot) and a value v (fp32, or bf16 upcast exactly to
// fp32).  Tile t reads x segment seg[t]:  acc[row_local * LANES + l] +=
// v * x[seg[t] * W + col_local], summed in fp32.  SpMM does the same for
// each of the N columns of X (laid out (K_pad, N) row-major) into
// acc (R_pad, N).
//
// Bound on this card (H100 SXM, 3.35 TB/s HBM): the work is a pure stream,
// 2 flops per slot and column, so bytes bound it.  Bytes that must move:
// idx 4 B plus val 4 B (fp32) or 2 B (bf16) per slot, x read once and acc
// written once.  At the G7 stand-in (33.5 M slots at the default config)
// that is 0.28 GB in fp32, 0.084 ms.
//
// SpMV design (Hopper).  Lane l only ever adds into column l of the
// (R, LANES) accumulator, so a group of lanes owns a part of acc that no
// other lane touches: as the paper's PEs keep their rows in on-chip memory
// and the TPU kernel keeps acc in VMEM, one block keeps a lane group's
// accumulator (a window of its lane-local rows) in shared memory and
// reduces into it, not into global memory.  Blocks are (lane group, row
// window, tile split) cells, about one per SM; the wrapper's plan
// (kernels/serpens_spmv.py::spmv_plan) picks the largest group whose rows
// fit the 227 KB a block may use (4 lanes at G7, 12,735 rows each).  A
// thread loads one lane's idx and value (loads that skip L1, 4 slots in
// flight), gathers x through L1 (tiles are sorted by segment, so a block
// gathers from one 32 KB x segment at a time) and reduces into shared
// memory; at the end the block writes its window out once.  What bounds
// it here is the stream's layout, not the bytes: a group's lanes are a
// 16-byte strip of each 512-byte stream row, so every request carries 16
// useful bytes (tools/spmv_variants.py: at G7 reading and decoding the
// stream alone takes about 0.29 ms against 0.084 ms of bytes).  Reductions
// into shared memory reorder the fp32 sums, so results match the plain
// version within a tolerance, not bitwise.
//
// SpMM design (Hopper).  A 128-thread block decodes a tile's slots once,
// coalesced, and packs the live ones (X row, acc row, value) into shared
// memory, then spreads the tile's column work over all its threads: item k
// is column group k % (N / VEC) of live slot k / (N / VEC), so the threads
// of one slot are neighbours, read one contiguous X row and update one
// contiguous acc row.
// Each item moves VEC columns: a float4/float2 load of X and one sm_90
// vector fp32 reduction (atomicAdd on float4/float2, RED.F32x4/x2) into
// acc; VEC = 1 is the scalar case.  A thread issues the X loads of a batch
// of items together.  The wrapper picks VEC from N and the alignment of X
// and runs one pass per window of acc rows that fits in L2
// (kernels/serpens_spmv.py::spmm_plan): a pass decodes the whole stream
// but packs, and so gathers and reduces, only the slots of its window.
//
// Traps handled here: the packed word is decoded with unsigned shifts (a
// live row of 0xFFFF packs into a negative int32 that is not the -1
// sentinel), and slot and element offsets are 64-bit.  Offsets that would
// leave x or acc are skipped, as the reference's scatter drops them (and
// as zero padding of x to the segment grid would give).
//
// The fused solver step (serpens_spmv_fused) is one pass over A followed by
// one solver iteration's vector work, with the loop's state on the card.
// The TPU kernel runs a traced Python epilogue in its last sequential grid
// step; here blocks run in no order, so the step is a short chain of
// kernels on one stream: zero acc (only when the stream pass splits its
// tiles), the stream pass above, then two or three epilogue passes over
// the (R, LANES) state and a one-block commit.  Each epilogue pass writes
// one partial sum per block; the next pass reduces them in a fixed order
// (every block the same order, so every block gets the same scalar).  The
// commit writes the loop's scalars and its control word ctrl = [cont, it]:
// it += 1, cont = measure > stop && it < max_iters, the reference's
// while_loop condition.  Every kernel of the chain returns at once when
// cont == 0, so the host can enqueue iterations ahead and read ctrl once
// per chunk; iterations after convergence move no bytes.  x is read in
// place from the state vector (x_len bounds it), and the state is updated
// in place only by passes after the stream pass has finished.  Bound: the
// stream pass's bytes plus each state vector read or written once; the
// epilogue passes re-read the state (a few MB at G7), which the fused TPU
// kernel kept in VMEM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// -- SpMV: the stream pass --------------------------------------------------
// Threads of a stream-pass block, and the slots each thread loads before it
// applies them.
constexpr int kSpmvThreads = 1024;
constexpr int kSpmvUnroll = 4;
// The largest dynamic shared memory a block may ask for on sm_90 (227 KB).
constexpr int kSpmvMaxSmem = 232448;
// Stream loads skip L1 (L1::no_allocate), which keeps the x segment.
__device__ __forceinline__ uint32_t load_word(const int32_t* p) {
  uint32_t w;
  asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];\n" : "=r"(w) : "l"(p));
  return w;
}
__device__ __forceinline__ float load_val(const float* p) {
  return __uint_as_float(load_word(reinterpret_cast<const int32_t*>(p)));
}
__device__ __forceinline__ float load_val(const __nv_bfloat16* p) {
  unsigned short h;
  asm("ld.global.nc.L1::no_allocate.u16 %0, [%1];\n" : "=h"(h) : "l"(p));
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

// One block per (lane group, row window, split): lanes [glo, glo + gw),
// lane-local rows [rlo, rhi) and tiles [t0, t1).  The block's accumulator,
// (rhi - rlo) x gw fp32 with each lane's rows contiguous, lives in shared
// memory; every slot of its lanes whose row lies in the window adds into
// it, and the block then writes it out once: plain stores when it is the
// only split, else fp32 reductions.  rows = ceil(acc_len / lanes)
// lane-local rows, cut into `windows` equal windows; the tiles into
// `splits` equal ranges.
template <typename V>
__global__ void __launch_bounds__(kSpmvThreads)
spmv_kernel(const int32_t* __restrict__ idx, const V* __restrict__ val,
            const int32_t* __restrict__ seg, const float* __restrict__ x,
            float* __restrict__ acc, int num_tiles, int sub, int lanes,
            int seg_width, int64_t x_len, int64_t acc_len, int lane_group,
            int rows, int windows, int splits, const int* ctrl) {
  extern __shared__ float s_acc[];
  // ctrl (fused solver step only): the loop has stopped, make no pass.
  if (ctrl != nullptr && ctrl[0] == 0) return;
  const int groups = (lanes + lane_group - 1) / lane_group;
  const int g = blockIdx.x % groups;
  const int w = blockIdx.x / groups % windows;
  const int s = blockIdx.x / groups / windows;
  const int glo = g * lane_group;
  const int gw = min(lane_group, lanes - glo);
  const int rlo = static_cast<int>(int64_t{rows} * w / windows);
  const int rhi = static_cast<int>(int64_t{rows} * (w + 1) / windows);
  // Lane-major: the window rows of one lane are contiguous, so the random
  // rows of a warp's reductions spread over all 32 banks.
  const int wrows = rhi - rlo;
  const int n_acc = wrows * gw;
  for (int i = threadIdx.x; i < n_acc; i += kSpmvThreads) s_acc[i] = 0.f;
  __syncthreads();

  const int row0 = static_cast<int>(int64_t{num_tiles} * s / splits) * sub;
  const int row1 =
      static_cast<int>(int64_t{num_tiles} * (s + 1) / splits) * sub;
  // Thread i keeps lane glo + i % gw and walks rows i / gw, + rstep, ...
  // (the threads past the last whole row of lanes wait); a tile is a
  // shift of its row when sub is a power of two.
  const int rstep = kSpmvThreads / gw;
  const int64_t lane_off = glo + threadIdx.x % gw;
  const int sub_shift = (sub & (sub - 1)) ? -1 : __ffs(sub) - 1;
  const int first = threadIdx.x < rstep * gw ? row0 + threadIdx.x / gw
                                             : row1;
  for (int r0 = first; r0 < row1; r0 += rstep * kSpmvUnroll) {
    uint32_t wd[kSpmvUnroll];
    float v[kSpmvUnroll];
    int xseg[kSpmvUnroll];
    // All of a thread's stream and segment loads in flight together.
#pragma unroll
    for (int u = 0; u < kSpmvUnroll; ++u) {
      const int r = r0 + u * rstep;
      wd[u] = 0xFFFFFFFFu;
      xseg[u] = 0;
      if (r < row1) {
        const int64_t off = int64_t{r} * lanes + lane_off;
        wd[u] = load_word(idx + off);
        v[u] = load_val(val + off);
        xseg[u] = seg[sub_shift >= 0 ? r >> sub_shift : r / sub];
      }
    }
    // Decode (unsigned: a live row 0xFFFF packs negative), then all the
    // x gathers, then the shared-memory reductions.
    int dst[kSpmvUnroll];
    float xv[kSpmvUnroll];
    const int lane_acc = static_cast<int>(lane_off - glo) * wrows - rlo;
#pragma unroll
    for (int u = 0; u < kSpmvUnroll; ++u) {
      const uint32_t word = wd[u];
      const int row = static_cast<int>(word >> 16);
      const int64_t col = int64_t{xseg[u]} * seg_width + (word & 0xFFFFu);
      const bool live = word != 0xFFFFFFFFu && row >= rlo && row < rhi &&
                        col < x_len;
      dst[u] = live ? lane_acc + row : -1;
      xv[u] = live ? __ldg(x + col) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kSpmvUnroll; ++u)
      if (dst[u] >= 0) atomicAdd(s_acc + dst[u], v[u] * xv[u]);
  }
  __syncthreads();

  // Write the window out, row by row (a row's lanes are contiguous in
  // acc); elements at or past acc_len are dropped.
  for (int i = threadIdx.x; i < n_acc; i += kSpmvThreads) {
    const int q = i / gw;
    const int l = i - q * gw;
    const int64_t d = int64_t{rlo + q} * lanes + glo + l;
    if (d >= acc_len) continue;
    const float a = s_acc[l * wrows + q];
    if (splits == 1)
      acc[d] = a;
    else
      atomicAdd(acc + d, a);
  }
}

// The stream pass's geometry, as the C entries receive it.
struct SpmvGeo {
  int64_t num_tiles;
  int sub, lanes, seg_width;
  int64_t x_len, acc_len;
  int lane_group, windows, splits;
  // Derived by spmv_geo_check: lane-local rows, blocks, shared bytes.
  int rows, blocks, smem;
};

// Fills the derived fields; cudaErrorInvalidValue for a geometry the body
// does not take (the wrapper's plan never gives one).
cudaError_t spmv_geo_check(SpmvGeo& g) {
  const int64_t kMax = (int64_t{1} << 31) - 1;
  if (g.sub < 1 || g.lanes < 1 || g.num_tiles < 0 || g.acc_len < 0 ||
      g.lane_group < 1 || g.lane_group > g.lanes ||
      g.lane_group > kSpmvThreads || g.windows < 1 ||
      g.splits < 1 || g.num_tiles * g.sub * g.lanes > kMax)
    return cudaErrorInvalidValue;
  const int64_t rows = g.acc_len > 0 ? (g.acc_len + g.lanes - 1) / g.lanes
                                     : 1;
  const int64_t groups = (g.lanes + g.lane_group - 1) / g.lane_group;
  const int64_t smem = int64_t{g.lane_group} *
                       ((rows + g.windows - 1) / g.windows) * 4;
  const int64_t blocks = groups * g.windows * g.splits;
  if (g.windows > rows || smem > kSpmvMaxSmem || blocks > kMax)
    return cudaErrorInvalidValue;
  g.rows = static_cast<int>(rows);
  g.blocks = static_cast<int>(blocks);
  g.smem = static_cast<int>(smem);
  return cudaSuccess;
}

// Devices whose spmv_kernel<V> may already take the largest shared
// accumulator.
constexpr int kMaxDevices = 64;

// Lets spmv_kernel<V> ask for kSpmvMaxSmem on the current device, once per
// device; the driver picks the carve-out.
template <typename V>
cudaError_t spmv_allow_smem() {
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && allowed[dev])) return err;
  err = cudaFuncSetAttribute(spmv_kernel<V>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSpmvMaxSmem);
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = true;
  return err;
}

template <typename V>
cudaError_t launch_spmv_t(const SpmvGeo& g, const void* idx, const void* val,
                          const void* seg, const void* x, void* acc,
                          const int* ctrl, cudaStream_t st) {
  const cudaError_t err = spmv_allow_smem<V>();
  if (err != cudaSuccess) return err;
  spmv_kernel<V><<<g.blocks, kSpmvThreads, g.smem, st>>>(
      static_cast<const int32_t*>(idx), static_cast<const V*>(val),
      static_cast<const int32_t*>(seg), static_cast<const float*>(x),
      static_cast<float*>(acc), static_cast<int>(g.num_tiles), g.sub,
      g.lanes, g.seg_width, g.x_len, g.acc_len, g.lane_group, g.rows,
      g.windows, g.splits, ctrl);
  return cudaGetLastError();
}

cudaError_t launch_spmv(const SpmvGeo& g, int value_bf16, const void* idx,
                        const void* val, const void* seg, const void* x,
                        void* acc, const int* ctrl, cudaStream_t st) {
  return value_bf16 ? launch_spmv_t<__nv_bfloat16>(g, idx, val, seg, x, acc,
                                                   ctrl, st)
                    : launch_spmv_t<float>(g, idx, val, seg, x, acc, ctrl,
                                           st);
}

// -- SpMM --------------------------------------------------------------------
// Threads of an SpMM block, and the slots it decodes into shared memory at
// a time (one default tile).
constexpr int kSpmmThreads = 128;
constexpr int kSpmmChunk = 1024;

template <int VEC> struct FVec;
template <> struct FVec<1> { using T = float; };
template <> struct FVec<2> { using T = float2; };
template <> struct FVec<4> { using T = float4; };

__device__ __forceinline__ float scaled(float v, float a) { return v * a; }
__device__ __forceinline__ float2 scaled(float v, float2 a) {
  return make_float2(v * a.x, v * a.y);
}
__device__ __forceinline__ float4 scaled(float v, float4 a) {
  return make_float4(v * a.x, v * a.y, v * a.z, v * a.w);
}

// x: (x_rows, n) and acc: (row_hi, n), n = groups * VEC, both bases
// VEC-float aligned.  Only slots whose row lies in [row_lo, row_hi) are
// applied.
template <typename V, int VEC>
__global__ void __launch_bounds__(kSpmmThreads)
spmm_kernel(const int32_t* __restrict__ idx, const V* __restrict__ val,
            const int32_t* __restrict__ seg, const float* __restrict__ x,
            float* __restrict__ acc, int sub, int lanes, int seg_width,
            int groups, int64_t x_rows, int64_t row_lo, int64_t row_hi) {
  using T = typename FVec<VEC>::T;
  const int64_t n = static_cast<int64_t>(groups) * VEC;
  // Column items a thread keeps in flight (its X loads issue together);
  // at VEC = 4, 8 items take 96 registers and slow the row-window passes.
  constexpr int kBatch = VEC == 4 ? 4 : 8;
  constexpr int kPerThread = kSpmmChunk / kSpmmThreads;
  __shared__ int32_t s_col[kSpmmChunk];
  __shared__ int32_t s_dst[kSpmmChunk];
  __shared__ float s_val[kSpmmChunk];
  __shared__ int s_live;
  const int wl = threadIdx.x & 31;
  const int64_t slots = static_cast<int64_t>(sub) * lanes;
  const int64_t t = blockIdx.x;            // one block per tile
  const int64_t xbase = static_cast<int64_t>(seg[t]) * seg_width;
  const int64_t tile = t * slots;
  for (int64_t q0 = 0; q0 < slots; q0 += kSpmmChunk) {
    const int nq = static_cast<int>(
        slots - q0 < kSpmmChunk ? slots - q0 : kSpmmChunk);
    if (threadIdx.x == 0) s_live = 0;
    // Decode each slot once, coalesced, all loads of a thread in flight.
    uint32_t w[kPerThread];
    float v[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int q = i * kSpmmThreads + threadIdx.x;
      w[i] = 0xFFFFFFFFu;
      if (q < nq) {
        w[i] = static_cast<uint32_t>(idx[tile + q0 + q]);
        v[i] = to_f32(val[tile + q0 + q]);
      }
    }
    __syncthreads();
    // Keep the live slots whose row lies in the window, packed: X row,
    // acc row, value.  The launcher refuses x_rows or row_hi >= 2^31.
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int64_t slot = q0 + i * kSpmmThreads + threadIdx.x;
      const int64_t c = xbase + (w[i] & 0xFFFFu);
      const int64_t d =
          static_cast<int64_t>(w[i] >> 16) * lanes + slot % lanes;
      const bool live = w[i] != 0xFFFFFFFFu && c < x_rows && d >= row_lo &&
                        d < row_hi;
      const unsigned mask = __ballot_sync(0xFFFFFFFFu, live);
      int base = 0;
      if (wl == 0 && mask != 0u) base = atomicAdd(&s_live, __popc(mask));
      base = __shfl_sync(0xFFFFFFFFu, base, 0);
      if (live) {
        const int at = base + __popc(mask & ((1u << wl) - 1u));
        s_col[at] = static_cast<int32_t>(c);
        s_dst[at] = static_cast<int32_t>(d);
        s_val[at] = v[i];
      }
    }
    __syncthreads();
    // Item k is column group k % groups of live slot k / groups, so the
    // threads of one slot are neighbours: one contiguous X row read and
    // one contiguous acc row updated together.
    const int items = s_live * groups;
    for (int k0 = 0; k0 < items; k0 += kSpmmThreads * kBatch) {
      int32_t col[kBatch], dst[kBatch], j[kBatch];
      float a[kBatch];
      T xv[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int k = k0 + i * kSpmmThreads + threadIdx.x;
        col[i] = -1;
        dst[i] = j[i] = 0;
        a[i] = 0.f;
        if (k < items) {
          const int q = k / groups;
          col[i] = s_col[q];
          dst[i] = s_dst[q];
          a[i] = s_val[q];
          j[i] = (k - q * groups) * VEC;
        }
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        if (col[i] >= 0)
          xv[i] = *reinterpret_cast<const T*>(x + col[i] * n + j[i]);
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        if (col[i] >= 0)
          atomicAdd(reinterpret_cast<T*>(acc + dst[i] * n + j[i]),
                    scaled(a[i], xv[i]));
    }
    __syncthreads();
  }
}

template <typename V, int VEC>
cudaError_t launch_spmm(const void* idx, const void* val, const void* seg,
                        const void* x, void* acc, int64_t num_tiles, int sub,
                        int lanes, int seg_width, int n, int64_t x_rows,
                        int64_t row_lo, int64_t row_hi, cudaStream_t st) {
  // One block per tile (fewer blocks that loop over tiles ran slower).
  spmm_kernel<V, VEC><<<num_tiles, kSpmmThreads, 0, st>>>(
      static_cast<const int32_t*>(idx), static_cast<const V*>(val),
      static_cast<const int32_t*>(seg), static_cast<const float*>(x),
      static_cast<float*>(acc), sub, lanes, seg_width, n / VEC, x_rows,
      row_lo, row_hi);
  return cudaGetLastError();
}

// -- fused solver step: epilogue passes -------------------------------------
// Every epilogue pass and the commit run kEpiThreads threads a block, so a
// partial-sum reduction takes the same order in each of them.
constexpr int kEpiThreads = 256;

// Epilogue ids.  EPILOGUE_SPECS in kernels/serpens_spmv.py holds them with
// the extras and outputs each epilogue's kernels below read and write.
enum Epilogue : int { kCG = 0, kPageRank = 1, kPower = 2 };

struct EpiArgs {
  float* acc;        // A·x, flat (R * LANES)
  int64_t n;         // R * LANES
  float* e0;         // extras, flat; what each holds depends on the epilogue
  float* e1;
  float* e2;
  float* e3;
  float* scal;       // the loop's scalar outputs
  float* part;       // partial sums, three regions of nb floats
  int nb;            // blocks of an epilogue pass
  int* ctrl;         // [cont, it]
  float stop;
  int max_iters;
};

// Sum over the block; every thread gets the total.  smem: 33 floats.
__device__ float block_sum(float v, float* smem) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = threadIdx.x < (blockDim.x >> 5) ? smem[threadIdx.x] : 0.f;
    for (int o = 16; o > 0; o >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, o);
    if (threadIdx.x == 0) smem[32] = v;
  }
  __syncthreads();
  return smem[32];
}

// The total of nb partials, in the same order in every block.
__device__ float sum_partials(const float* part, int nb, float* smem) {
  float v = 0.f;
  for (int i = threadIdx.x; i < nb; i += blockDim.x) v += part[i];
  return block_sum(v, smem);
}

__device__ __forceinline__ int64_t first_elem() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}
__device__ __forceinline__ int64_t elem_stride() {
  return static_cast<int64_t>(gridDim.x) * blockDim.x;
}

// One thread (thread 0 of the one-block commit) ends the iteration.
__device__ void commit(const EpiArgs& a, float measure) {
  const int it = a.ctrl[1] + 1;
  a.ctrl[1] = it;
  a.ctrl[0] = (measure > a.stop) && (it < a.max_iters);
}

__global__ void fused_zero(EpiArgs a) {
  if (a.ctrl[0] == 0) return;
  for (int64_t i = first_elem(); i < a.n; i += elem_stride()) a.acc[i] = 0.f;
}

// CG (reference solvers/cg.py::_cg_epilogue).  e0 sol, e1 r, e2 p (also x
// of the stream pass), e3 rs (one float).  acc = A·p.
__global__ void cg_dot(EpiArgs a) {            // denom = Σ p·Ap
  __shared__ float sm[33];
  if (a.ctrl[0] == 0) return;
  float s = 0.f;
  for (int64_t i = first_elem(); i < a.n; i += elem_stride())
    s += a.e2[i] * a.acc[i];
  s = block_sum(s, sm);
  if (threadIdx.x == 0) a.part[blockIdx.x] = s;
}

__global__ void cg_update(EpiArgs a) {         // sol += αp, r -= αAp, Σ r²
  __shared__ float sm[33];
  if (a.ctrl[0] == 0) return;
  const float denom = sum_partials(a.part, a.nb, sm);
  const float alpha = a.e3[0] / (denom != 0.f ? denom : 1e-30f);
  float s = 0.f;
  for (int64_t i = first_elem(); i < a.n; i += elem_stride()) {
    a.e0[i] = a.e0[i] + alpha * a.e2[i];
    const float r = a.e1[i] - alpha * a.acc[i];
    a.e1[i] = r;
    s += r * r;
  }
  s = block_sum(s, sm);
  if (threadIdx.x == 0) a.part[a.nb + blockIdx.x] = s;
}

__global__ void cg_direction(EpiArgs a) {      // p = r + βp
  __shared__ float sm[33];
  if (a.ctrl[0] == 0) return;
  const float rs_new = sum_partials(a.part + a.nb, a.nb, sm);
  const float rs = a.e3[0];
  const float beta = rs_new / (rs != 0.f ? rs : 1e-30f);
  for (int64_t i = first_elem(); i < a.n; i += elem_stride())
    a.e2[i] = a.e1[i] + beta * a.e2[i];
}

__global__ void cg_commit(EpiArgs a) {         // rs = rs_new; ‖r‖ > stop
  __shared__ float sm[33];
  if (a.ctrl[0] == 0) return;
  const float rs_new = sum_partials(a.part + a.nb, a.nb, sm);
  if (threadIdx.x == 0) {
    a.e3[0] = rs_new;
    commit(a, sqrtf(rs_new));
  }
}

// PageRank (reference solvers/power_iteration.py::_pagerank_epilogue).
// e0 r (also x), e1 mask, e2 consts = [damping, n].  scal[0] = delta.
__global__ void pr_sum(EpiArgs a) {            // Σ link, link = d·acc
  __shared__ float sm[33];
  if (a.ctrl[0] == 0) return;
  const float d = a.e2[0];
  float s = 0.f;
  for (int64_t i = first_elem(); i < a.n; i += elem_stride())
    s += d * a.acc[i];
  s = block_sum(s, sm);
  if (threadIdx.x == 0) a.part[blockIdx.x] = s;
}

__global__ void pr_update(EpiArgs a) {         // r_new, Σ|r_new − r|
  __shared__ float sm[33];
  if (a.ctrl[0] == 0) return;
  const float link_sum = sum_partials(a.part, a.nb, sm);
  const float d = a.e2[0];
  const float teleport = (1.f - link_sum) / a.e2[1];
  float s = 0.f;
  for (int64_t i = first_elem(); i < a.n; i += elem_stride()) {
    const float r_new = (d * a.acc[i] + teleport) * a.e1[i];
    s += fabsf(r_new - a.e0[i]);
    a.e0[i] = r_new;
  }
  s = block_sum(s, sm);
  if (threadIdx.x == 0) a.part[a.nb + blockIdx.x] = s;
}

__global__ void pr_commit(EpiArgs a) {
  __shared__ float sm[33];
  if (a.ctrl[0] == 0) return;
  const float delta = sum_partials(a.part + a.nb, a.nb, sm);
  if (threadIdx.x == 0) {
    a.scal[0] = delta;
    commit(a, delta);
  }
}

// Power iteration (reference solvers/power_iteration.py::_power_epilogue).
// e0 v (also x).  scal[0] = λ, scal[1] = residual.
__global__ void pw_dots(EpiArgs a) {           // λ = Σ v·Av, Σ Av²
  __shared__ float sm[33];
  if (a.ctrl[0] == 0) return;
  float s0 = 0.f, s1 = 0.f;
  for (int64_t i = first_elem(); i < a.n; i += elem_stride()) {
    const float av = a.acc[i];
    s0 += a.e0[i] * av;
    s1 += av * av;
  }
  s0 = block_sum(s0, sm);
  s1 = block_sum(s1, sm);
  if (threadIdx.x == 0) {
    a.part[blockIdx.x] = s0;
    a.part[a.nb + blockIdx.x] = s1;
  }
}

__global__ void pw_update(EpiArgs a) {         // Σ(Av − λv)², v = Av/‖Av‖
  __shared__ float sm[33];
  if (a.ctrl[0] == 0) return;
  const float lam = sum_partials(a.part, a.nb, sm);
  const float nrm = sqrtf(sum_partials(a.part + a.nb, a.nb, sm));
  float s = 0.f;
  for (int64_t i = first_elem(); i < a.n; i += elem_stride()) {
    const float av = a.acc[i];
    const float v = a.e0[i];
    const float dv = av - lam * v;
    s += dv * dv;
    a.e0[i] = nrm > 0.f ? av / fmaxf(nrm, 1e-30f) : v;
  }
  s = block_sum(s, sm);
  if (threadIdx.x == 0) a.part[2 * a.nb + blockIdx.x] = s;
}

__global__ void pw_commit(EpiArgs a) {
  __shared__ float sm[33];
  if (a.ctrl[0] == 0) return;
  const float lam = sum_partials(a.part, a.nb, sm);
  const float res = sqrtf(sum_partials(a.part + 2 * a.nb, a.nb, sm));
  if (threadIdx.x == 0) {
    a.scal[0] = lam;
    a.scal[1] = res;
    commit(a, res);
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Pointers and the stream are
// passed as void*; `value_bf16` selects the value type.  Each returns
// cudaGetLastError() after the launch, so a refused launch is reported.
// One stream pass y = A·x into acc (acc_len floats) with lane groups of
// lane_group lanes, `windows` row windows and `splits` tile ranges.  acc
// must be zero first when splits > 1; with one split the pass writes every
// element.  Refuses (cudaErrorInvalidValue) a geometry spmv_geo_check
// refuses.
extern "C" int serpens_spmv(const void* idx, const void* val, const void* seg,
                            const void* x, void* acc, int64_t num_tiles,
                            int sub, int lanes, int seg_width, int64_t x_len,
                            int64_t acc_len, int value_bf16, int lane_group,
                            int windows, int splits, void* stream) {
  SpmvGeo g{num_tiles, sub, lanes, seg_width, x_len, acc_len, lane_group,
            windows, splits, 0, 0, 0};
  cudaError_t err = spmv_geo_check(g);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_spmv(g, value_bf16, idx, val, seg, x, acc,
                                      nullptr,
                                      static_cast<cudaStream_t>(stream)));
}

// One SpMM pass over the stream for X (x_rows, n) into acc (row_hi, n),
// VEC = vec floats a thread at a time, applying the slots whose row lies
// in [row_lo, row_hi).  Refuses (cudaErrorInvalidValue) a vec other than
// 1, 2 or 4, an n that is not a multiple of vec, a base that is not
// vec-aligned, and row or tile counts of 2^31 or more.
extern "C" int serpens_spmm(const void* idx, const void* val, const void* seg,
                            const void* x, void* acc, int64_t num_tiles,
                            int sub, int lanes, int seg_width, int n, int vec,
                            int64_t x_rows, int64_t row_lo, int64_t row_hi,
                            int value_bf16, void* stream) {
  const uintptr_t align = static_cast<uintptr_t>(vec) * sizeof(float);
  if ((vec != 1 && vec != 2 && vec != 4) || n < 1 || n % vec ||
      reinterpret_cast<uintptr_t>(x) % align ||
      reinterpret_cast<uintptr_t>(acc) % align ||
      x_rows >= (int64_t{1} << 31) || row_hi >= (int64_t{1} << 31) ||
      num_tiles >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_tiles == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SERPENS_SPMM(V, VEC)                                                 \
  launch_spmm<V, VEC>(idx, val, seg, x, acc, num_tiles, sub, lanes,         \
                      seg_width, n, x_rows, row_lo, row_hi, st)
  cudaError_t err;
  if (value_bf16) {
    err = vec == 4   ? SERPENS_SPMM(__nv_bfloat16, 4)
          : vec == 2 ? SERPENS_SPMM(__nv_bfloat16, 2)
                     : SERPENS_SPMM(__nv_bfloat16, 1);
  } else {
    err = vec == 4   ? SERPENS_SPMM(float, 4)
          : vec == 2 ? SERPENS_SPMM(float, 2)
                     : SERPENS_SPMM(float, 1);
  }
#undef SERPENS_SPMM
  return static_cast<int>(err);
}

// One fused solver step: zero acc (only when the stream pass has more than
// one split), one stream pass (geometry as for serpens_spmv; x read from
// x_len floats), the epilogue's passes over nb blocks, and the commit.
// Returns the first launch error, or 0.  `part` holds 3 * nb floats.
extern "C" int serpens_spmv_fused(
    int epilogue, const void* idx, const void* val, const void* seg,
    const void* x, void* acc, int64_t num_tiles, int sub, int lanes,
    int seg_width, int64_t x_len, int64_t acc_len, int value_bf16,
    int lane_group, int windows, int splits, void* e0, void* e1, void* e2,
    void* e3, void* scal, void* part, int nb, void* ctrl, float stop,
    int max_iters, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  SpmvGeo g{num_tiles, sub, lanes, seg_width, x_len, acc_len, lane_group,
            windows, splits, 0, 0, 0};
  cudaError_t err = spmv_geo_check(g);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (epilogue < kCG || epilogue > kPower)
    return static_cast<int>(cudaErrorInvalidValue);
  EpiArgs a{static_cast<float*>(acc), acc_len, static_cast<float*>(e0),
            static_cast<float*>(e1), static_cast<float*>(e2),
            static_cast<float*>(e3), static_cast<float*>(scal),
            static_cast<float*>(part), nb, static_cast<int*>(ctrl), stop,
            max_iters};
#define SERPENS_LAUNCH(...)                            \
  do {                                                 \
    __VA_ARGS__;                                       \
    if ((err = cudaGetLastError()) != cudaSuccess)     \
      return static_cast<int>(err);                    \
  } while (0)
  if (splits > 1) SERPENS_LAUNCH(fused_zero<<<nb, kEpiThreads, 0, st>>>(a));
  if ((err = launch_spmv(g, value_bf16, idx, val, seg, x, acc,
                         static_cast<const int*>(ctrl), st)) != cudaSuccess)
    return static_cast<int>(err);
  switch (epilogue) {
    case kCG:
      SERPENS_LAUNCH(cg_dot<<<nb, kEpiThreads, 0, st>>>(a));
      SERPENS_LAUNCH(cg_update<<<nb, kEpiThreads, 0, st>>>(a));
      SERPENS_LAUNCH(cg_direction<<<nb, kEpiThreads, 0, st>>>(a));
      SERPENS_LAUNCH(cg_commit<<<1, kEpiThreads, 0, st>>>(a));
      break;
    case kPageRank:
      SERPENS_LAUNCH(pr_sum<<<nb, kEpiThreads, 0, st>>>(a));
      SERPENS_LAUNCH(pr_update<<<nb, kEpiThreads, 0, st>>>(a));
      SERPENS_LAUNCH(pr_commit<<<1, kEpiThreads, 0, st>>>(a));
      break;
    default:
      SERPENS_LAUNCH(pw_dots<<<nb, kEpiThreads, 0, st>>>(a));
      SERPENS_LAUNCH(pw_update<<<nb, kEpiThreads, 0, st>>>(a));
      SERPENS_LAUNCH(pw_commit<<<1, kEpiThreads, 0, st>>>(a));
      break;
  }
#undef SERPENS_LAUNCH
  return 0;
}
