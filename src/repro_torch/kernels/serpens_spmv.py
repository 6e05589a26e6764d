"""Serpens stream SpMV/SpMM: the CUDA kernels' wrappers and plain versions.

The kernels (``csrc/serpens_spmv.cu``) replace the reference package's TPU
kernels ``spmv_pallas`` and ``spmm_pallas``.  They are compiled with
``nvcc`` for ``sm_90a`` into ``build/`` at the repository root on first
use, loaded with ``ctypes`` and launched on PyTorch's current stream.

:func:`spmv` and :func:`spmm` take the stream and a padded x and return the
fp32 accumulator.  On CUDA tensors they launch the kernel (and count the
launch in :data:`spmv_launches` / :data:`spmm_launches`); on CPU tensors
they run the plain version, :func:`spmv_plain` / :func:`spmm_plain`, which
decodes, gathers and ``index_add_``-s in fp32 like the reference's XLA
stream path.  Nothing falls back: a CUDA tensor either runs the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from repro_torch.core.format import COL_MASK, ROW_BITS

# Launch counters: each wrapper adds one where it launches its kernel and
# nowhere else, so a run can show that its path went through the kernels.
spmv_launches = 0
spmm_launches = 0

_SOURCE = Path(__file__).resolve().parent / "csrc" / "serpens_spmv.cu"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
# -Xptxas=-v only adds the registers/spills report to the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the Serpens CUDA kernels are built "
                       "from source on first use and need the CUDA toolkit")


def build() -> tuple[Path, str]:
    """Compile the kernel source into ``build/`` (cached by content hash).

    Returns the shared library's path and nvcc's log ("" when the library
    was already built).
    """
    src = _SOURCE.read_bytes()
    tag = hashlib.sha256(src + repr(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _BUILD_DIR / f"serpens_spmv-{tag}.so"
    if out.exists():
        return out, ""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(_SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def _library() -> ctypes.CDLL:
    """Build (first call only) and load the kernel library."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()[0]))
            p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            lib.serpens_spmv.argtypes = [p, p, p, p, p, i64, i32, i32, i32,
                                         i64, i64, i32, i32, p]
            lib.serpens_spmv.restype = i32
            lib.serpens_spmm.argtypes = [p, p, p, p, p, i64, i32, i32, i32,
                                         i32, i64, i64, i32, i32, p]
            lib.serpens_spmm.restype = i32
            _lib = lib
        return _lib


# -- input checks (shared by kernel and plain paths) -------------------------
def _check_stream(idx, val, seg_ids, tiles_per_chunk: int) -> None:
    """The reference wrapper's checks, on the per-tile ``seg_ids``."""
    if idx.dim() != 3 or val.shape != idx.shape:
        raise ValueError(f"idx {tuple(idx.shape)} and val "
                         f"{tuple(val.shape)} must both be (tiles, sub, "
                         f"lanes)")
    num_tiles = idx.shape[0]
    if num_tiles % tiles_per_chunk:
        raise ValueError(
            f"stream has {num_tiles} tiles, not a multiple of "
            f"tiles_per_chunk={tiles_per_chunk}")
    if tuple(seg_ids.shape) != (num_tiles,):
        raise ValueError(
            f"seg_ids shaped {tuple(seg_ids.shape)}, expected "
            f"({num_tiles},) — a wrong length would silently mis-index x "
            f"segments")
    if idx.dtype != torch.int32 or seg_ids.dtype != torch.int32:
        raise ValueError("idx and seg_ids must be int32")
    if val.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"val must be float32 or bfloat16, got {val.dtype}")


def _check_device(*tensors) -> torch.device:
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}: the stream "
                             f"and x must share one device")
    return dev


def _check_kernel_args(idx, val, seg_ids, x, segment_width: int) -> None:
    for name, t in (("idx", idx), ("val", val), ("seg_ids", seg_ids),
                    ("x", x)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")
    if x.shape[0] % segment_width:
        raise ValueError(f"x has {x.shape[0]} rows, not a multiple of "
                         f"segment_width={segment_width}")
    lanes = idx.shape[2]
    if not 1 <= lanes <= 1024:
        raise ValueError(f"lanes={lanes}: one thread per lane needs "
                         f"1 <= lanes <= 1024")


def _grid(device: torch.device, num_tiles: int) -> int:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(num_tiles, sms * 16))


def _raise_on(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {status}")


# -- plain versions -----------------------------------------------------------
def _decode(idx, seg_ids, segment_width: int, lanes: int):
    """Decode the packed stream: live mask and global rows/cols (int64)."""
    live = idx != -1
    w = idx.to(torch.int64) & 0xFFFFFFFF          # unsigned view of the word
    lane = torch.arange(lanes, device=idx.device, dtype=torch.int64)
    rows = torch.where(live, (w >> ROW_BITS) & COL_MASK, 0) * lanes + lane
    cols = (seg_ids.to(torch.int64)[:, None, None] * segment_width
            + torch.where(live, w & COL_MASK, 0))
    return live, rows, cols


def spmv_plain(idx, val, seg_ids, x, *, num_rows_padded: int,
               segment_width: int):
    """Plain ``A @ x`` over the stream: decode, gather, fp32 ``index_add_``."""
    live, rows, cols = _decode(idx, seg_ids, segment_width, idx.shape[2])
    contrib = torch.where(live, val.float() * x[cols], 0.0)
    acc = torch.zeros(num_rows_padded, dtype=torch.float32, device=x.device)
    return acc.index_add_(0, rows.reshape(-1), contrib.reshape(-1))


def spmm_plain(idx, val, seg_ids, x, *, num_rows_padded: int,
               segment_width: int):
    """Plain ``A @ X`` for X (K_pad, N) → (num_rows_padded, N)."""
    live, rows, cols = _decode(idx, seg_ids, segment_width, idx.shape[2])
    v = torch.where(live, val.float(), 0.0).reshape(-1, 1)
    contrib = v * x[cols.reshape(-1)]
    acc = torch.zeros((num_rows_padded, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    return acc.index_add_(0, rows.reshape(-1), contrib)


# -- wrappers -----------------------------------------------------------------
def spmv(idx, val, seg_ids, x, *, num_rows_padded: int, segment_width: int,
         tiles_per_chunk: int = 1):
    """``A @ x`` over the Serpens stream → fp32 ``(num_rows_padded,)``.

    Args:
      idx: int32 ``(tiles, sub, lanes)`` packed stream words.
      val: float32 or bfloat16 ``(tiles, sub, lanes)`` values.
      seg_ids: int32 ``(tiles,)`` x segment of each tile.
      x: float32 ``(num_segments * segment_width,)`` zero-padded vector.
    """
    _check_stream(idx, val, seg_ids, tiles_per_chunk)
    if x.dim() != 1:
        raise ValueError(f"spmv needs a 1-D x, got {tuple(x.shape)}")
    dev = _check_device(idx, val, seg_ids, x)
    if dev.type == "cpu":
        return spmv_plain(idx, val, seg_ids, x,
                          num_rows_padded=num_rows_padded,
                          segment_width=segment_width)
    if dev.type != "cuda":
        raise ValueError(f"no Serpens kernel for device {dev}")
    _check_kernel_args(idx, val, seg_ids, x, segment_width)
    global spmv_launches
    lib = _library()
    acc = torch.zeros(num_rows_padded, dtype=torch.float32, device=dev)
    num_tiles, sub, lanes = idx.shape
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = lib.serpens_spmv(
        idx.data_ptr(), val.data_ptr(), seg_ids.data_ptr(), x.data_ptr(),
        acc.data_ptr(), num_tiles, sub, lanes, segment_width, x.shape[0],
        num_rows_padded, int(val.dtype == torch.bfloat16),
        _grid(dev, num_tiles), stream)
    _raise_on(status, "serpens_spmv")
    spmv_launches += 1
    return acc


def spmm(idx, val, seg_ids, x, *, num_rows_padded: int, segment_width: int,
         tiles_per_chunk: int = 1):
    """``A @ X`` for X float32 ``(K_pad, N)`` → fp32 ``(num_rows_padded, N)``
    (same stream arguments as :func:`spmv`)."""
    _check_stream(idx, val, seg_ids, tiles_per_chunk)
    if x.dim() != 2:
        raise ValueError(f"spmm needs a (K_pad, N) x, got {tuple(x.shape)}")
    dev = _check_device(idx, val, seg_ids, x)
    if dev.type == "cpu":
        return spmm_plain(idx, val, seg_ids, x,
                          num_rows_padded=num_rows_padded,
                          segment_width=segment_width)
    if dev.type != "cuda":
        raise ValueError(f"no Serpens kernel for device {dev}")
    _check_kernel_args(idx, val, seg_ids, x, segment_width)
    global spmm_launches
    lib = _library()
    n = x.shape[1]
    acc = torch.zeros((num_rows_padded, n), dtype=torch.float32, device=dev)
    num_tiles, sub, lanes = idx.shape
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = lib.serpens_spmm(
        idx.data_ptr(), val.data_ptr(), seg_ids.data_ptr(), x.data_ptr(),
        acc.data_ptr(), num_tiles, sub, lanes, segment_width, n, x.shape[0],
        num_rows_padded, int(val.dtype == torch.bfloat16),
        _grid(dev, num_tiles), stream)
    _raise_on(status, "serpens_spmm")
    spmm_launches += 1
    return acc
