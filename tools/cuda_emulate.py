"""Run the flash-attention backward kernel's CUDA source on the CPU.

The machine without a card has no ``nvcc``, so a kernel's indexing,
masks, shared-memory layout and fragment layouts are first seen on the
card.  This tool compiles ``kernels/csrc/flash_attention_bwd.cu`` with the
host's ``g++`` against a small emulation of what it uses from CUDA: one
``std::thread`` per CUDA thread and one block at a time, barriers for
``__syncthreads``/``__syncwarp``, a warp's exchange for
``__shfl_xor_sync``, ``mma.sync`` m16n8k16 (bf16 operands, fp32
accumulate) computed from the 32 lanes' fragments, bf16 rounded to
nearest even, and dynamic shared memory filled with garbage.  The result
binds to the same ``extern "C"`` interface as the card's build, so
:func:`emulated_bwd` takes CPU tensors as the wrapper takes CUDA ones.

It says nothing of speed, registers or the card's exp and rounding; the
card tests (``tests/test_torch_chip.py``) and ``chip_smoke.py`` phase 13
hold the real build.  It rewrites the source's text (the ``mma.sync``
asm, ``extern __shared__``, launches), so it follows the present
``mma.sync`` design only: a redesign of the backward retires it
(ROADMAP, Queue 2).  Run::

    PYTHONPATH=src python3 tools/cuda_emulate.py

which builds into ``build/emulated/`` (seconds) and prints each case's
largest relative error against ``flash_attention_bwd_plain``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels import flash_attention as fa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "emulated")

EMULATION = r"""
#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct emu_uint3 { unsigned x, y, z; };
inline thread_local emu_uint3 threadIdx, blockIdx;
inline emu_uint3 gridDim;
struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
struct __nv_bfloat16 { unsigned short bits; };
inline float __bfloat162float(__nv_bfloat16 b) {
  uint32_t u = (uint32_t)b.bits << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u)
    return {(unsigned short)((u >> 16) | 64)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(unsigned short)(u >> 16)};
}
typedef int cudaError_t;
typedef void* cudaStream_t;
const int cudaSuccess = 0, cudaErrorInvalidValue = 1;
const int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
template <typename K> cudaError_t cudaFuncSetAttribute(K, int, int) {
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }

struct EmuBarrier {
  std::mutex m;
  std::condition_variable cv;
  int n, count = 0, gen = 0;
  explicit EmuBarrier(int n_) : n(n_) {}
  void wait() {
    std::unique_lock<std::mutex> lock(m);
    const int g = gen;
    if (++count == n) {
      count = 0;
      ++gen;
      cv.notify_all();
    } else {
      cv.wait(lock, [&] { return g != gen; });
    }
  }
};
struct EmuBlock {
  std::unique_ptr<EmuBarrier> block;
  std::vector<std::unique_ptr<EmuBarrier>> warps;
  std::vector<float> shfl;
  std::vector<uint32_t> frag;
  std::vector<char> smem;
};
inline thread_local EmuBlock* emu_block;
inline void __syncthreads() { emu_block->block->wait(); }
inline void __syncwarp() { emu_block->warps[threadIdx.x / 32]->wait(); }
inline float __shfl_xor_sync(unsigned, float v, int off) {
  float* buf = &emu_block->shfl[threadIdx.x / 32 * 32];
  const int lane = threadIdx.x % 32;
  __syncwarp();
  buf[lane] = v;
  __syncwarp();
  const float r = buf[lane ^ off];
  __syncwarp();
  return r;
}
inline float emu_half(uint32_t word, int hi) {
  return __bfloat162float({(unsigned short)(hi ? word >> 16 : word)});
}
// mma.sync.m16n8k16.row.col bf16 -> fp32: A (16 x 16) in a[0..3] of the
// 32 lanes, B (16 x 8) in b0, b1, C in c[0..3], PTX's fragment layouts.
inline void emu_mma(float c[4], const uint32_t a[4], uint32_t b0,
                    uint32_t b1) {
  uint32_t* buf = &emu_block->frag[threadIdx.x / 32 * 32 * 6];
  const int lane = threadIdx.x % 32;
  __syncwarp();
  for (int i = 0; i < 4; ++i) buf[lane * 6 + i] = a[i];
  buf[lane * 6 + 4] = b0;
  buf[lane * 6 + 5] = b1;
  __syncwarp();
  const int gr = lane >> 2, tq = lane & 3;
  for (int e = 0; e < 4; ++e) {
    const int r = gr + 8 * (e >> 1), n = 2 * tq + (e & 1);
    float acc = c[e];
    for (int k = 0; k < 16; ++k) {
      const int al = (r % 8) * 4 + (k % 8) / 2, ar = (r >= 8) + 2 * (k >= 8);
      const int bl = n * 4 + (k % 8) / 2, br = 4 + (k >= 8);
      acc += emu_half(buf[al * 6 + ar], k % 2) *
             emu_half(buf[bl * 6 + br], k % 2);
    }
    c[e] = acc;
  }
  __syncwarp();
}
inline uint4* emu_smem() {
  return reinterpret_cast<uint4*>(emu_block->smem.data());
}
template <typename K, typename... A>
void emu_launch(K kern, dim3 grid, int threads, int smem, cudaStream_t,
                A... args) {
  gridDim = {grid.x, grid.y, grid.z};
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      EmuBlock blk;
      blk.block.reset(new EmuBarrier(threads));
      for (int w = 0; w < threads / 32; ++w)
        blk.warps.emplace_back(new EmuBarrier(32));
      blk.shfl.assign(threads, 0.f);
      blk.frag.assign(threads * 6, 0u);
      blk.smem.assign(smem, (char)0x7f);
      std::vector<std::thread> ts;
      for (int t = 0; t < threads; ++t)
        ts.emplace_back([&, t] {
          emu_block = &blk;
          threadIdx = {(unsigned)t, 0, 0};
          blockIdx = {bx, by, 0};
          kern(args...);
        });
      for (auto& th : ts) th.join();
    }
}
"""


def emulated_source(stem: str) -> str:
    """``csrc/<stem>.cu`` for the host compiler: CUDA headers replaced by
    :data:`EMULATION`, launches by ``emu_launch``, the dynamic shared
    array by the block's buffer, and the ``mma.sync`` asm by ``emu_mma``."""
    with open(kbuild.CSRC / f"{stem}.cu") as f:
        src = f.read()
    src = re.sub(r"#include <cuda[^>]*>\n", "", src)
    src, n = re.subn(r"(\w+)<<<(.*?)>>>\(", r"emu_launch(\1, \2, ", src,
                     flags=re.S)
    src, m = re.subn(r"extern __shared__ uint4 smem16\[\];",
                     "uint4* smem16 = emu_smem();", src)
    src, k = re.subn(r'asm volatile\(\s*"mma\.sync.*?\);',
                     "emu_mma(c, a, b0, b1);", src, flags=re.S)
    if not (n and m and k):
        raise AssertionError(f"{stem}.cu: launches {n}, shared arrays {m}, "
                             f"mma asm {k}: the emulation no longer fits")
    return EMULATION + src


def build(stem: str = "flash_attention_bwd") -> ctypes.CDLL:
    """The emulated library, built with ``g++`` into ``build/emulated/``
    (cached by the source's hash)."""
    src = emulated_source(stem)
    tag = hashlib.sha256(src.encode()).hexdigest()[:16]
    out = os.path.join(OUT, f"{stem}-{tag}.so")
    if not os.path.exists(out):
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("the emulation needs a host C++ compiler "
                               "(g++)")
        os.makedirs(OUT, exist_ok=True)
        cpp = f"{out}.{os.getpid()}.cpp"
        with open(cpp, "w") as f:
            f.write(src)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                               "-pthread", "-w", "-o", tmp, cpp],
                              capture_output=True, text=True)
        os.remove(cpp)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on the emulated {stem}.cu:\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(out)
    fa._declare_bwd(lib)
    return lib


def emulated_bwd(lib, q, k, v, o, do, *, causal=True, prefix_len=0):
    """``(dq, dk, dv)`` of the emulated kernel on CPU tensors, called as the
    wrapper calls the card's build."""
    b, sq, sk, kvh, g, dh, dv = fa._check_grad_inputs(q, k, v, o, do)
    dq, dk, dvv = (torch.full_like(t, float("nan")) for t in (q, k, v))
    lse = torch.empty((b, kvh, g, sq))
    dsum = torch.empty_like(lse)
    status = lib.flash_attention_bwd(
        *(t.data_ptr() for t in (q, k, v, o, do, dq, dk, dvv, lse, dsum)),
        b, sq, sk, kvh, g, dh, dv, int(causal), min(prefix_len, sk),
        int(q.dtype == torch.bfloat16), dh ** -0.5, None)
    if status != 0:
        raise RuntimeError(f"emulated flash_attention_bwd: status {status}")
    return dq, dk, dvv


# (b, sq, sk, kv heads, g, dh, dv, causal, prefix_len): each build width
# (64, 128, 256), GQA, dh != dv, prefixes, Sq != Sk, ragged tiles.
CASES = {
    "d64-ragged": (1, 70, 70, 2, 1, 64, 64, True, 0),
    "gqa": (1, 70, 70, 1, 2, 64, 64, True, 0),
    "non-causal-sq-lt-sk": (1, 40, 100, 1, 2, 32, 48, False, 0),
    "mla-96-64": (1, 130, 130, 1, 1, 96, 64, True, 0),
    "prefix": (1, 100, 100, 1, 2, 64, 64, True, 70),
    "d256": (1, 66, 66, 1, 1, 256, 256, True, 0),
    "128-40-non-causal": (1, 50, 90, 1, 1, 128, 40, False, 0),
    "odd-24-prefix": (2, 33, 33, 1, 1, 24, 24, True, 5),
}


def case_inputs(case, dtype, seed=0):
    b, sq, sk, kvh, g, dh, dv, causal, prefix = case
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((b, sq, kvh, g, dh), generator=gen).to(dtype)
    k = torch.randn((b, sk, kvh, dh), generator=gen).to(dtype)
    v = torch.randn((b, sk, kvh, dv), generator=gen).to(dtype)
    do = torch.randn((b, sq, kvh, g, dv), generator=gen).to(dtype)
    o = fa.flash_attention_plain(q, k, v, causal=causal, prefix_len=prefix)
    return q, k, v, o, do


def relative_errors(lib, case, dtype) -> list[float]:
    """dq, dk, dv of the emulated kernel against the plain version, each
    in norm."""
    *_, causal, prefix = case
    q, k, v, o, do = case_inputs(case, dtype)
    got = emulated_bwd(lib, q, k, v, o, do, causal=causal, prefix_len=prefix)
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, causal=causal,
                                        prefix_len=prefix)
    return [float((a.float() - w.float()).norm() / w.float().norm())
            for a, w in zip(got, want)]


def main() -> int:
    lib = build()
    for dtype in (torch.float32, torch.bfloat16):
        for name, case in CASES.items():
            errs = relative_errors(lib, case, dtype)
            print(f"{name} {dtype}: dq, dk, dv ||Δ||/||plain|| "
                  + ", ".join(f"{e:.2e}" for e in errs), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
