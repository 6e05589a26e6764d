// Serpens stream SpMV / SpMM for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX reference package:
//   src/repro/kernels/serpens_spmv.py::spmv_pallas (body _spmv_kernel)
//   src/repro/kernels/serpens_spmv.py::spmm_pallas (body _spmm_kernel)
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
// Design (first, simple version).  One 128-thread block walks tiles with a
// grid stride; thread l is lane l, so each warp's idx/val loads are
// coalesced.  Each thread walks its SUB slots: decode, gather x, and an
// fp32 atomicAdd into acc in global memory.  Atomics are required: with
// raw_window < SUB a destination row may repeat inside a tile, and blocks
// share rows.  They reorder the fp32 sums, so results match the plain
// version within a tolerance, not bitwise.  The scattered fp32 atomics to
// L2 are the likely limiter of this design; a shared-memory row-block
// accumulator and TMA streaming of idx/val are later work.
//
// Traps handled here: the packed word is decoded with unsigned shifts (a
// live row of 0xFFFF packs into a negative int32 that is not the -1
// sentinel), and every slot / x / acc offset is 64-bit.  Offsets that would
// leave x or acc are skipped, as the reference's scatter drops them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename V>
__global__ void spmv_kernel(const int32_t* __restrict__ idx,
                            const V* __restrict__ val,
                            const int32_t* __restrict__ seg,
                            const float* __restrict__ x,
                            float* __restrict__ acc, int64_t num_tiles,
                            int sub, int lanes, int seg_width, int64_t x_len,
                            int64_t acc_len) {
  const int lane = threadIdx.x;
  for (int64_t t = blockIdx.x; t < num_tiles; t += gridDim.x) {
    const int64_t xbase = static_cast<int64_t>(seg[t]) * seg_width;
    const int64_t base = t * sub * lanes + lane;
    for (int s = 0; s < sub; ++s) {
      const int64_t off = base + static_cast<int64_t>(s) * lanes;
      const uint32_t w = static_cast<uint32_t>(idx[off]);
      if (w == 0xFFFFFFFFu) continue;
      const int64_t col = xbase + (w & 0xFFFFu);
      const int64_t dst = static_cast<int64_t>(w >> 16) * lanes + lane;
      if (col >= x_len || dst >= acc_len) continue;
      atomicAdd(acc + dst, to_f32(val[off]) * x[col]);
    }
  }
}

template <typename V>
__global__ void spmm_kernel(const int32_t* __restrict__ idx,
                            const V* __restrict__ val,
                            const int32_t* __restrict__ seg,
                            const float* __restrict__ x,
                            float* __restrict__ acc, int64_t num_tiles,
                            int sub, int lanes, int seg_width, int n,
                            int64_t x_rows, int64_t acc_rows) {
  const int lane = threadIdx.x;
  for (int64_t t = blockIdx.x; t < num_tiles; t += gridDim.x) {
    const int64_t xbase = static_cast<int64_t>(seg[t]) * seg_width;
    const int64_t base = t * sub * lanes + lane;
    for (int s = 0; s < sub; ++s) {
      const int64_t off = base + static_cast<int64_t>(s) * lanes;
      const uint32_t w = static_cast<uint32_t>(idx[off]);
      if (w == 0xFFFFFFFFu) continue;
      const int64_t col = xbase + (w & 0xFFFFu);
      const int64_t dst = static_cast<int64_t>(w >> 16) * lanes + lane;
      if (col >= x_rows || dst >= acc_rows) continue;
      const float v = to_f32(val[off]);
      const float* xr = x + col * n;
      float* ar = acc + dst * n;
      for (int j = 0; j < n; ++j) atomicAdd(ar + j, v * xr[j]);
    }
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Pointers and the stream are
// passed as void*; `value_bf16` selects the value type.  Each returns
// cudaGetLastError() after the launch, so a refused launch is reported.
extern "C" int serpens_spmv(const void* idx, const void* val, const void* seg,
                            const void* x, void* acc, int64_t num_tiles,
                            int sub, int lanes, int seg_width, int64_t x_len,
                            int64_t acc_len, int value_bf16, int grid,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_tiles > 0) {
    if (value_bf16) {
      spmv_kernel<__nv_bfloat16><<<grid, lanes, 0, st>>>(
          static_cast<const int32_t*>(idx),
          static_cast<const __nv_bfloat16*>(val),
          static_cast<const int32_t*>(seg), static_cast<const float*>(x),
          static_cast<float*>(acc), num_tiles, sub, lanes, seg_width, x_len,
          acc_len);
    } else {
      spmv_kernel<float><<<grid, lanes, 0, st>>>(
          static_cast<const int32_t*>(idx), static_cast<const float*>(val),
          static_cast<const int32_t*>(seg), static_cast<const float*>(x),
          static_cast<float*>(acc), num_tiles, sub, lanes, seg_width, x_len,
          acc_len);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int serpens_spmm(const void* idx, const void* val, const void* seg,
                            const void* x, void* acc, int64_t num_tiles,
                            int sub, int lanes, int seg_width, int n,
                            int64_t x_rows, int64_t acc_rows, int value_bf16,
                            int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_tiles > 0) {
    if (value_bf16) {
      spmm_kernel<__nv_bfloat16><<<grid, lanes, 0, st>>>(
          static_cast<const int32_t*>(idx),
          static_cast<const __nv_bfloat16*>(val),
          static_cast<const int32_t*>(seg), static_cast<const float*>(x),
          static_cast<float*>(acc), num_tiles, sub, lanes, seg_width, n,
          x_rows, acc_rows);
    } else {
      spmm_kernel<float><<<grid, lanes, 0, st>>>(
          static_cast<const int32_t*>(idx), static_cast<const float*>(val),
          static_cast<const int32_t*>(seg), static_cast<const float*>(x),
          static_cast<float*>(acc), num_tiles, sub, lanes, seg_width, n,
          x_rows, acc_rows);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
