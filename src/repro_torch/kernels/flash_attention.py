"""Flash attention: the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/flash_attention.cu``) replaces the reference package's
TPU kernel ``flash_attention`` (``repro/kernels/flash_attention.py``): an
online-softmax attention that keeps its running max, normaliser and
accumulator in fp32 on chip, so each call reads Q, K and V and writes O
once.  It has three bodies, and :func:`flash_body` picks one from the
inputs' dtype, head dims and alignment alone:

* ``"wgmma"``: bf16 with ``(dh, dv)`` in :data:`WGMMA_HEAD_DIMS` and
  16-byte-aligned bases (the served heads, heads of 256 among them).  TMA
  brings K/V tiles into a ring of shared-memory stages and ``wgmma`` runs
  both products; its rank-4 tensor maps are described by
  :func:`tma_geometry`.
* ``"mma"``: every other bf16 shape (misaligned views, pairs such as
  (256, 128)), on ``mma.sync`` tensor cores.
* ``"fma"``: fp32, on CUDA-core FMAs (fp32 products, as the reference's).

Head dims go up to :data:`MAX_HEAD_DIM` (256).  Under ``causal`` a
``prefix_len`` makes the keys before it visible to every row (prefix-LM:
a VLM's image tokens), the mask of the reference's ``chunked_attention``.

The choice is no fallback: a body that fails to build or launch raises.
The source is compiled by ``nvcc`` for ``sm_90a`` into ``build/`` at the
repository root on first use (``kernels/build.py``), loaded with
``ctypes`` and launched on PyTorch's current stream.

:func:`flash_attention` takes the reference's layout.  On CUDA tensors it
launches the kernel (and counts the launch in :data:`flash_launches` and
:data:`flash_launches_by_body`); on CPU tensors it runs
:func:`flash_attention_plain`.  Nothing falls back: a CUDA tensor either
runs the kernel or raises.

The gradient (``csrc/flash_attention_bwd.cu``, its own library) replaces
no TPU kernel: the reference trains through jax autodiff of its plain
``chunked_attention``.  :func:`flash_attention_bwd` gives ``(dq, dk, dv)``
from the forward's inputs, its output and the output's gradient, in three
launches (row statistics; dK and dV per key tile; dQ per q tile) with no
atomics, and counts each call in :data:`flash_bwd_launches`;
:func:`flash_attention_bwd_plain` is the same function in torch ops.
:class:`FlashAttention` is the autograd Function the model calls on the
card: its forward is :func:`flash_attention`, its backward
:func:`flash_attention_bwd`.
"""
from __future__ import annotations

import ctypes
import operator
from typing import NamedTuple

import torch

from repro_torch.kernels import build as _build

# Launch counter: the wrapper adds one where it launches the kernel and
# nowhere else, so a run can show that its path went through the kernel.
flash_launches = 0
flash_launches_by_body = {"wgmma": 0, "mma": 0, "fma": 0}
flash_bwd_launches = 0

NEG_INF = -1e30
# The mma and fma bodies keep a 64-row tile of q, K and V in shared memory
# and acc in registers, built at 64, 128 and 256 columns: head dims up to
# 256.
MAX_HEAD_DIM = 256
_Q_TILE = 64
_MAX_GRID_Y = 65535
# Rows of q per step of the plain version: bounds its fp32 score tensor.
_PLAIN_CHUNK = 512

# The wgmma body: the (dh, dv) pairs it is built for (the served heads:
# qwen1.5's, chatglm3's and llama4's, minicpm3's multi-head latent
# attention, rope 32 + nope 64 against v 64, and paligemma's heads of
# 256); q rows per TMA box (one consumer warpgroup's rows; a block takes
# two) and each pair's keys per kv tile, both compiled into the kernel
# (``WgCfg``: 64 keys at 256 columns, where O alone takes half a consumer
# thread's registers; 128 elsewhere); 64 bf16 columns per box, the most a
# 128-byte swizzle takes, so a head of 128 is two boxes side by side, one
# of 256 four, and one of 96 two boxes whose second TMA fills past column
# 96 with zeros.
_WG_KV_TILE = {(64, 64): 128, (128, 128): 128, (96, 64): 128,
               (256, 256): 64}
WGMMA_HEAD_DIMS = tuple(_WG_KV_TILE)
_WG_Q_BOX_ROWS = 64
_BOX_COLS = 64
_BF16_BYTES = 2


def build():
    """Compile ``csrc/flash_attention.cu`` (see :func:`.build.build`)."""
    return _build.build("flash_attention")


def build_bwd():
    """Compile ``csrc/flash_attention_bwd.cu`` (see :func:`.build.build`)."""
    return _build.build("flash_attention_bwd")


def _declare(lib) -> None:
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [p, p, p, p, i32, i32, i32, i32, i32,
                                        i32, i32, i32, i32, i32,
                                        ctypes.c_float, p]
    lib.flash_attention_fwd.restype = i32
    i64s, i32s = ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(i32)
    lib.flash_attention_fwd_wgmma.argtypes = [
        p, p, p, p, i64s, i64s, i32s, i32, i32, i32, i32, i32, i32, i32,
        i32, i32, i32, i32, ctypes.c_float, p]
    lib.flash_attention_fwd_wgmma.restype = i32
    lib.flash_attention_wgmma_smem_bytes.argtypes = [i32, i32]
    lib.flash_attention_wgmma_smem_bytes.restype = i32


def _declare_bwd(lib) -> None:
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_bwd.argtypes = [p] * 10 + [i32] * 10 + [
        ctypes.c_float, p]
    lib.flash_attention_bwd.restype = i32


class TensorMap(NamedTuple):
    """One rank-4 TMA map: global dims and box dims innermost first, and
    the byte strides of dims 1-3 (dim 0 is contiguous)."""
    dims: tuple[int, int, int, int]
    strides: tuple[int, int, int]
    box: tuple[int, int, int, int]


def tma_geometry(b, sq, sk, kvh, g, dh, dv) -> dict:
    """The wgmma body's maps of q, k (``dh`` columns), v and o (``dv``
    columns), each the reference layout read as (d, heads, S, B) with no
    reshaping copy: a box spans one head and rows along S (k and v: the
    pair's key tile), so a tile never crosses a batch.  Also
    ``"qk_col_boxes"`` and ``"vo_col_boxes"``, the boxes side by side
    across ``dh`` and across ``dv``."""
    def tmap(d, rows, heads, box_rows):
        row = heads * d * _BF16_BYTES
        return TensorMap((d, heads, rows, b), (d * _BF16_BYTES, row,
                                                rows * row),
                         (_BOX_COLS, 1, box_rows, 1))
    kv_tile = _WG_KV_TILE[dh, dv]
    return {"q": tmap(dh, sq, kvh * g, _WG_Q_BOX_ROWS),
            "k": tmap(dh, sk, kvh, kv_tile),
            "v": tmap(dv, sk, kvh, kv_tile),
            "o": tmap(dv, sq, kvh * g, _WG_Q_BOX_ROWS),
            "qk_col_boxes": -(-dh // _BOX_COLS),
            "vo_col_boxes": -(-dv // _BOX_COLS)}


def wgmma_smem_bytes(dh: int, dv: int) -> int:
    """Dynamic shared memory one block of the wgmma body takes at head
    dims ``(dh, dv)`` (q tile, K/V ring, barriers), from the built
    library."""
    return _build.load("flash_attention",
                       _declare).flash_attention_wgmma_smem_bytes(dh, dv)


def flash_body(q, k, v) -> str:
    """The body that runs these (checked) inputs on the card: ``"fma"``
    for fp32; ``"wgmma"`` for bf16 with ``(dh, dv)`` in
    :data:`WGMMA_HEAD_DIMS` and every base 16-byte aligned (so every row
    stride is a multiple of 16 bytes, as TMA needs); ``"mma"`` for any
    other bf16 shape."""
    if q.dtype == torch.float32:
        return "fma"
    dh, dv = q.shape[-1], v.shape[-1]
    if (dh, dv) in WGMMA_HEAD_DIMS and \
            all(t.data_ptr() % 16 == 0 for t in (q, k, v)):
        return "wgmma"
    return "mma"


def _check(q, k, v) -> tuple[int, ...]:
    """Shapes, dtypes and device of one call; returns
    ``(b, sq, sk, kvh, g, dh, dv)``."""
    if q.dim() != 5 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"need q (B, Sq, KV, G, dh), k (B, Sk, KV, dh), v "
                         f"(B, Sk, KV, dv); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, kvh, g, dh = q.shape
    sk, dv = k.shape[1], v.shape[3]
    if tuple(k.shape) != (b, sk, kvh, dh) or \
            tuple(v.shape) != (b, sk, kvh, dv):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if min(b, sq, sk, kvh, g, dh, dv) < 1:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype or \
            q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q, k, v must share float32 or bfloat16; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    return b, sq, sk, kvh, g, dh, dv


def _check_prefix(prefix_len) -> int:
    prefix_len = operator.index(prefix_len)
    if prefix_len < 0:
        raise ValueError(f"prefix_len must be >= 0, got {prefix_len}")
    return prefix_len


def flash_attention_plain(q, k, v, *, causal=True, prefix_len=0):
    """The kernel's function in torch ops: fp32 scores and softmax over
    whole rows, P rounded to v's dtype before P·V in fp32, output in q's
    dtype.  q runs in chunks of rows to bound the score tensor."""
    b, sq, sk, kvh, g, dh, dv = _check(q, k, v)
    prefix_len = _check_prefix(prefix_len)
    scale = dh ** -0.5
    kf, vf = k.float(), v.float()
    out = torch.empty((b, sq, kvh, g, dv), dtype=q.dtype, device=q.device)
    kpos = torch.arange(sk, device=q.device)
    for c0 in range(0, sq, _PLAIN_CHUNK):
        qc = q[:, c0:c0 + _PLAIN_CHUNK].float()
        s = torch.einsum("bckgd,bskd->bkgcs", qc, kf) * scale
        if causal:
            qpos = torch.arange(c0, c0 + qc.shape[1], device=q.device)
            ok = (kpos[None, :] <= qpos[:, None]) | \
                (kpos[None, :] < prefix_len)
            s = s.masked_fill(~ok, NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        if causal:
            p = p.masked_fill(~ok, 0.0)
        den = p.sum(dim=-1).clamp_min(1e-30).permute(0, 3, 1, 2)
        pv = torch.einsum("bkgcs,bskd->bckgd", p.to(v.dtype).float(), vf)
        out[:, c0:c0 + _PLAIN_CHUNK] = (pv / den[..., None]).to(q.dtype)
    return out


def flash_attention(q, k, v, *, causal=True, prefix_len=0):
    """q: (B, Sq, KV, G, dh); k: (B, Sk, KV, dh); v: (B, Sk, KV, dv).

    Returns (B, Sq, KV, G, dv) in q's dtype: attention of each q row over
    the keys (``kpos <= qpos or kpos < prefix_len`` when causal, q and k
    both from position 0; ``prefix_len`` is ignored otherwise), head
    ``(kv, g)`` reading kv head ``kv``.
    """
    b, sq, sk, kvh, g, dh, dv = _check(q, k, v)
    prefix_len = _check_prefix(prefix_len)
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     prefix_len=prefix_len)
    if dev.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {dev}")
    if max(dh, dv) > MAX_HEAD_DIM:
        raise ValueError(f"head dims dh={dh}, dv={dv}: the kernel takes up "
                         f"to {MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if -(-sq // _Q_TILE) > _MAX_GRID_Y or b * kvh * g >= 2 ** 31:
        raise ValueError(f"q {tuple(q.shape)} is too large for one launch")
    global flash_launches
    body = flash_body(q, k, v)
    lib = _build.load("flash_attention", _declare)
    out = torch.empty((b, sq, kvh, g, dv), dtype=q.dtype, device=dev)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    # Keys past Sk are never seen, so a longer prefix is Sk's (and fits the
    # kernel's int).
    prefix = min(prefix_len, sk)
    if body == "wgmma":
        geo = tma_geometry(b, sq, sk, kvh, g, dh, dv)
        maps = [geo[n] for n in ("q", "k", "v", "o")]
        dims = (ctypes.c_longlong * 16)(*(x for m in maps for x in m.dims))
        strides = (ctypes.c_longlong * 12)(
            *(x for m in maps for x in m.strides))
        boxes = (ctypes.c_int * 16)(*(x for m in maps for x in m.box))
        # The scale is the true dh's, never the padded width's.
        status = lib.flash_attention_fwd_wgmma(
            *ptrs, dims, strides, boxes, geo["qk_col_boxes"],
            geo["vo_col_boxes"], b, sq, sk, kvh * g, g, dh, dv, int(causal),
            prefix, dh ** -0.5, stream)
    else:
        status = lib.flash_attention_fwd(
            *ptrs, b, sq, sk, kvh, g, dh, dv, int(causal), prefix,
            int(body == "mma"), dh ** -0.5, stream)
    if status < 0:
        raise RuntimeError(f"flash_attention ({body}): cuTensorMapEncodeTiled"
                           f" failed with CUresult {-status}")
    if status != 0:
        raise RuntimeError(f"flash_attention ({body}) launch failed: CUDA "
                           f"error {status}")
    flash_launches += 1
    flash_launches_by_body[body] += 1
    return out


def _check_grad_inputs(q, k, v, o, do) -> tuple[int, ...]:
    """:func:`_check` plus o and do: (B, Sq, KV, G, dv) in q's dtype and
    on its device."""
    dims = _check(q, k, v)
    b, sq, sk, kvh, g, dh, dv = dims
    for name, t in (("o", o), ("do", do)):
        if tuple(t.shape) != (b, sq, kvh, g, dv) or t.dtype != q.dtype or \
                t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} on "
                             f"{t.device} does not match q {tuple(q.shape)}"
                             f" {q.dtype} on {q.device} with dv={dv}")
    return dims


def flash_attention_bwd_plain(q, k, v, o, do, *, causal=True, prefix_len=0):
    """The kernel's gradient in torch ops: ``(dq, dk, dv)`` of
    :func:`flash_attention` at (q, k, v), given its output ``o`` and the
    output's gradient ``do``.  fp32 scores and softmax over whole rows,
    with explicit dP, dS, dQ, dK and dV: P is rounded to the inputs' dtype
    before dV = Pᵀ·dO, and dS = P ∘ (dP − D) (from the unrounded P, with
    D = rowsum(dO ∘ O)) before dQ = dS·K·scale and dK = dSᵀ·Q·scale, the
    kernel's rounding points; sums in fp32, results in q's dtype.  q runs
    in chunks of rows to bound the score tensor."""
    b, sq, sk, kvh, g, dh, dv = _check_grad_inputs(q, k, v, o, do)
    prefix_len = _check_prefix(prefix_len)
    scale = dh ** -0.5
    kf, vf = k.float(), v.float()
    dq = torch.empty_like(q)
    dk = torch.zeros((b, sk, kvh, dh), device=q.device)
    dvv = torch.zeros((b, sk, kvh, dv), device=q.device)
    kpos = torch.arange(sk, device=q.device)
    for c0 in range(0, sq, _PLAIN_CHUNK):
        rows = slice(c0, c0 + _PLAIN_CHUNK)
        qc, doc = q[:, rows].float(), do[:, rows].float()
        dsum = (doc * o[:, rows].float()).sum(-1).permute(0, 2, 3, 1)
        s = torch.einsum("bckgd,bskd->bkgcs", qc, kf) * scale
        if causal:
            qpos = torch.arange(c0, c0 + qc.shape[1], device=q.device)
            ok = (kpos[None, :] <= qpos[:, None]) | \
                (kpos[None, :] < prefix_len)
            s = s.masked_fill(~ok, NEG_INF)
        p = torch.softmax(s, dim=-1)
        if causal:
            p = p.masked_fill(~ok, 0.0)
        dvv += torch.einsum("bkgcs,bckgd->bskd", p.to(q.dtype).float(), doc)
        dp = torch.einsum("bckgd,bskd->bkgcs", doc, vf)
        ds = (p * (dp - dsum[..., None])).to(q.dtype).float()
        dq[:, rows] = (torch.einsum("bkgcs,bskd->bckgd", ds, kf)
                       * scale).to(q.dtype)
        dk += torch.einsum("bkgcs,bckgd->bskd", ds, qc) * scale
    return dq, dk.to(q.dtype), dvv.to(q.dtype)


def flash_attention_bwd(q, k, v, o, do, *, causal=True, prefix_len=0):
    """``(dq, dk, dv)``: the gradient of :func:`flash_attention` at
    (q, k, v) (the forward's layouts), given its output ``o`` (B, Sq, KV,
    G, dv) and the output's gradient ``do``, each in q's dtype and shape.
    GQA's dk and dv sum over the G heads of a group.

    On CUDA tensors it launches the kernel (three launches, counted once
    in :data:`flash_bwd_launches`); on CPU tensors it runs
    :func:`flash_attention_bwd_plain`.  A CUDA tensor runs the kernel or
    raises.
    """
    b, sq, sk, kvh, g, dh, dv = _check_grad_inputs(q, k, v, o, do)
    prefix_len = _check_prefix(prefix_len)
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, do, causal=causal,
                                         prefix_len=prefix_len)
    if dev.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {dev}")
    if max(dh, dv) > MAX_HEAD_DIM:
        raise ValueError(f"head dims dh={dh}, dv={dv}: the kernel takes up "
                         f"to {MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # fp32 tiles are 32 rows, bf16 64.
    if -(-max(sq, sk) // 32) > _MAX_GRID_Y or b * kvh * g >= 2 ** 31:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} is too "
                         f"large for one launch")
    global flash_bwd_launches
    lib = _build.load("flash_attention_bwd", _declare_bwd)
    dq, dk, dvv = (torch.empty_like(t) for t in (q, k, v))
    lse = torch.empty((b, kvh, g, sq), dtype=torch.float32, device=dev)
    dsum = torch.empty_like(lse)
    status = lib.flash_attention_bwd(
        *(t.data_ptr() for t in (q, k, v, o, do, dq, dk, dvv, lse, dsum)),
        b, sq, sk, kvh, g, dh, dv, int(causal), min(prefix_len, sk),
        int(q.dtype == torch.bfloat16), dh ** -0.5,
        torch.cuda.current_stream(dev).cuda_stream)
    if status != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error "
                           f"{status}")
    flash_bwd_launches += 1
    return dq, dk, dvv


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` with :func:`flash_attention_bwd` as its
    gradient: ``FlashAttention.apply(q, k, v, causal, prefix_len)``.  It
    saves q, k, v and the output only when one of q, k, v requires grad,
    so a call under serving (nothing requires grad) holds nothing more
    than :func:`flash_attention`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, prefix_len):
        o = flash_attention(q, k, v, causal=causal, prefix_len=prefix_len)
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(q, k, v, o)
        ctx.causal, ctx.prefix_len = causal, prefix_len
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.contiguous(),
                                         causal=ctx.causal,
                                         prefix_len=ctx.prefix_len)
        return dq, dk, dv, None, None


def traffic_bytes(b, sq, sk, kvh, g, dh, dv, dtype_bytes=2):
    """Analytic HBM traffic of one call, as the reference counts it: Q
    read once, O written once, and K/V conservatively once per 512-row q
    block."""
    nq = -(-sq // 512)
    q_bytes = b * sq * kvh * g * dh * dtype_bytes
    kv_bytes = b * sk * kvh * (dh + dv) * dtype_bytes * nq
    o_bytes = b * sq * kvh * g * dv * dtype_bytes
    return q_bytes + kv_bytes + o_bytes
