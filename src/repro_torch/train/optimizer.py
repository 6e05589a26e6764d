"""AdamW with warmup + cosine schedule, global-norm clipping and a
configurable moment dtype.

The port of the reference package's ``train/optimizer.py`` on the port's
parameter tree (dicts, and lists of period dicts).  The math is the
reference's, in fp32 whatever the parameter and moment dtypes: clip
scale, bias correction, decoupled weight decay, then a cast back to each
leaf's dtype.  Unlike the reference, which returns new trees,
:func:`update` writes the parameters and moments in place (under
``torch.no_grad``), so a step holds one fp32 temporary of a leaf at a
time instead of a second copy of the state.  The schedule is taken on the
host in fp32 (numpy), as the reference's; the gradient norm and the clip
scale stay on the device, so a step reads nothing back.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.layers import _dtype


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"   # "bfloat16" for very large models


def leaves(tree) -> list:
    """The tensors of a tree of dicts and lists, dict keys in sorted order
    (``jax.tree.leaves``'s order)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for e in tree for t in leaves(e)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` over every leaf, keeping the tree's dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, e) for e in tree]
    return fn(tree)


def schedule(cfg: OptimizerConfig, step: int) -> float:
    """Learning rate at ``step`` (1-based after the first update): linear
    warmup, then cosine decay to ``min_lr_ratio·lr``, in fp32."""
    f = np.float32
    step = f(step)
    warm = np.minimum(step / f(max(cfg.warmup_steps, 1)), f(1.0))
    prog = np.clip((step - f(cfg.warmup_steps))
                   / f(max(cfg.total_steps - cfg.warmup_steps, 1)),
                   f(0.0), f(1.0))
    cos = f(0.5) * (f(1) + np.cos(f(np.pi) * prog))
    return float(f(cfg.lr) * warm * (f(cfg.min_lr_ratio)
                                     + f(1 - cfg.min_lr_ratio) * cos))


def init(cfg: OptimizerConfig, params) -> dict:
    """Zero moments ``m`` and ``v`` in ``moment_dtype``, shaped as
    ``params`` and on its devices, and ``step`` 0."""
    dt = _dtype(cfg.moment_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": 0}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32 (a device
    scalar)."""
    return torch.sqrt(sum(x.float().square().sum() for x in leaves(tree)))


@torch.no_grad()
def update(cfg: OptimizerConfig, grads, opt_state: dict, params):
    """One AdamW step, in place: ``params`` and ``opt_state``'s moments are
    overwritten, its ``step`` advanced.  Returns ``(params, opt_state,
    metrics)`` with ``metrics`` ``{"grad_norm": device scalar (before
    clipping), "lr": float}``."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / gnorm.clamp_min(1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = float(1 - np.float32(b1) ** np.float32(step))
    bc2 = float(1 - np.float32(b2) ** np.float32(step))
    for p, g, m, v in zip(leaves(params), leaves(grads),
                          leaves(opt_state["m"]), leaves(opt_state["v"])):
        g32 = g.float() * scale
        m32 = b1 * m.float() + (1 - b1) * g32
        v32 = b2 * v.float() + (1 - b2) * g32.square()
        delta = (m32 / bc1) / ((v32 / bc2).sqrt() + cfg.eps)
        p32 = p.float()
        p.copy_(p32 - lr * (delta + cfg.weight_decay * p32))
        m.copy_(m32)
        v.copy_(v32)
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
