"""Checkpoints in the reference's format, with atomic writes and async
save.

The port of the reference package's ``train/checkpoint.py``: one
``np.savez`` file a step, ``<dir>/step_<n:08d>.npz``, written to
``<dir>/tmp.<n>`` and renamed into place (a crash mid-write never leaves
a partial checkpoint), the newest ``keep`` kept, the newest restored.
Keys are the reference's tree paths joined by ``/``
(``params/blocks/sub0/mixer/wq``, ``opt/m/...``, ``opt/step``,
``meta/step``): the port's lists of period and encoder-layer dicts are
stacked along a leading axis (``convert.lm_params_to_arrays``) as the
reference's vmapped stacks are, and restored by index.  So a file written
by either package restores in the port.

bf16 leaves are written as 2-byte void (``|V2``) arrays, the bytes the
reference's ``np.savez`` of an ``ml_dtypes.bfloat16`` array writes, and
read back as their ``uint16`` bit patterns viewed as ``torch.bfloat16``:
the machine with the card has no ``ml_dtypes``.  (The reference's own
restore casts ``|V2`` with ``astype`` and cannot read its bf16 files.)
A ``uint16`` numpy leaf is taken for bf16 bits the same way.
"""
from __future__ import annotations

import os
import re
import threading

import numpy as np
import torch

from repro_torch import convert

_BF16_FILE = np.dtype("V2")


def _flatten(tree) -> dict:
    """``{"a/b/c": numpy array}`` of a tree of dicts, lists of dicts
    (stacked), tensors, arrays and Python numbers: host copies."""
    out = {}

    def walk(node, key):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{key}/{k}" if key else str(k))
            return
        if torch.is_tensor(node) or isinstance(node, (list, tuple)):
            node = convert.lm_params_to_arrays({"x": node})["x"]
            if isinstance(node, dict):
                walk(node, key)
                return
        arr = np.asarray(node)
        out[key] = arr.view(_BF16_FILE) if arr.dtype == np.uint16 else arr

    walk(tree, "")
    return out


def _write(ckpt_dir, step, flat, keep):
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def save(ckpt_dir, step, tree, keep=3):
    os.makedirs(ckpt_dir, exist_ok=True)
    return _write(ckpt_dir, step, _flatten(tree), keep)


_PENDING: list[threading.Thread] = []


def save_async(ckpt_dir, step, tree, keep=3):
    """Copy to the host now; write to disk on a background thread."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(tree)
    t = threading.Thread(target=_write, args=(ckpt_dir, step, flat, keep),
                         daemon=True)
    t.start()
    _PENDING.append(t)
    return t


def wait_pending():
    for t in _PENDING:
        t.join()
    _PENDING.clear()


def latest_step(ckpt_dir) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := re.match(r"step_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def _leaf(arr, target):
    """A file's array as ``target``'s kind: a tensor of its dtype on its
    device, a numpy array of its dtype, or a Python number."""
    if arr.dtype == _BF16_FILE:
        arr = arr.view(np.uint16)
    if torch.is_tensor(target):
        if arr.dtype == np.uint16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        return t.to(device=target.device, dtype=target.dtype)
    if isinstance(target, (np.ndarray, np.generic)):
        return arr.astype(target.dtype)
    if isinstance(target, (int, float)):
        return type(target)(arr)
    return arr


def restore(ckpt_dir, target_tree, step=None):
    """Restore into the structure of ``target_tree`` (a list of dicts takes
    the stacked arrays by index); returns ``(tree, step)``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}

    def build(node, key, index=()):
        if isinstance(node, dict):
            return {k: build(v, f"{key}/{k}" if key else str(k), index)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [build(e, key, index + (i,)) for i, e in enumerate(node)]
        arr = flat[key]
        return _leaf(np.ascontiguousarray(arr[index]) if index else arr,
                     node)

    return build(target_tree, ""), step


def _gc(ckpt_dir, keep):
    files = sorted(f for f in os.listdir(ckpt_dir)
                   if re.match(r"step_\d+\.npz$", f))
    for f in files[:-keep]:
        os.remove(os.path.join(ckpt_dir, f))
