"""Carry an encoded plan, or an LM's weights, across from numpy arrays.

The SpMV system's "weights" are its encoded channel-shard plans.
:func:`plan_from_arrays` rebuilds this package's
:class:`~repro_torch.core.partition.ChannelShardPlan` from plain numpy
fields — those of a plan encoded by the JAX reference package, for
example — so both packages can run one and the same stream.

``fields`` holds:

* ``shape`` — global ``(M, K)``;
* ``config`` — the :class:`~repro_torch.core.format.SerpensConfig` fields;
* ``spec`` — the :class:`~repro_torch.core.partition.PlanSpec` fields;
* ``block_m``, ``block_k`` — the shard geometry;
* ``row_perm`` — the balanced-lane permutation, or None;
* ``shards`` — one dict per shard with ``shape``, ``nnz``,
  ``num_segments``, ``idx``, ``val``, ``seg_ids``, ``aux_rows``,
  ``aux_cols`` and ``aux_vals``.  A bf16 ``val`` arrives as its ``uint16``
  bit patterns.

:func:`lm_params_from_arrays` carries an LM's weights the same way (see
there), and :func:`lm_params_to_arrays` carries them back.  This module
imports numpy only; torch is imported inside the functions that need it.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import format as sformat
from repro_torch.core import partition as cpart

# LM leaves whose dtype the reference fixes whatever ``param_dtype``: the
# MoE router (``moe_init``) and the SSM's decay, step bias and skip
# (``ssm_init``) are fp32.
FP32_LEAVES = frozenset({"router", "a_log", "dt_bias", "d_skip"})


def _shard(d: dict, cfg: sformat.SerpensConfig) -> sformat.SerpensMatrix:
    idx = np.ascontiguousarray(d["idx"], np.int32)
    val = np.ascontiguousarray(d["val"])
    want = cfg.np_value_dtype
    if val.dtype != want:
        raise ValueError(f"shard val has dtype {val.dtype}; a "
                         f"{cfg.value_dtype} stream is held as {want}")
    if idx.ndim != 3 or idx.shape[1:] != (cfg.sublanes, cfg.lanes) \
            or val.shape != idx.shape:
        raise ValueError(f"shard idx {idx.shape} / val {val.shape} do not "
                         f"match (tiles, {cfg.sublanes}, {cfg.lanes})")
    seg_ids = np.ascontiguousarray(d["seg_ids"], np.int32)
    if seg_ids.shape != (idx.shape[0],):
        raise ValueError(f"shard seg_ids {seg_ids.shape}, expected "
                         f"({idx.shape[0]},)")
    return sformat.SerpensMatrix(
        shape=tuple(int(s) for s in d["shape"]), nnz=int(d["nnz"]),
        config=cfg, idx=idx, val=val, seg_ids=seg_ids,
        num_segments=int(d["num_segments"]),
        aux_rows=np.ascontiguousarray(d["aux_rows"], np.int32),
        aux_cols=np.ascontiguousarray(d["aux_cols"], np.int32),
        aux_vals=np.ascontiguousarray(d["aux_vals"], np.float32))


def plan_from_arrays(fields: dict) -> cpart.ChannelShardPlan:
    """Build a :class:`ChannelShardPlan` from the numpy fields of a plan."""
    cfg = sformat.SerpensConfig(**fields["config"])
    spec = cpart.PlanSpec(**fields["spec"])
    shards = [_shard(d, cfg) for d in fields["shards"]]
    if len(shards) != spec.num_shards:
        raise ValueError(f"{len(shards)} shards for a {spec.num_shards}-"
                         f"shard spec")
    row_perm = fields.get("row_perm")
    if row_perm is not None:
        row_perm = np.asarray(row_perm)
    return cpart.finish_plan(shards, fields["shape"], cfg, spec,
                             int(fields["block_m"]), int(fields["block_k"]),
                             row_perm=row_perm)


def lm_params_from_arrays(cfg, tree: dict, device=None) -> dict:
    """The port's LM parameters from the reference's ``LM.init`` tree as
    numpy arrays.

    ``tree["blocks"]`` is period-stacked (leading axis ``num_periods``)
    and ``tree["encoder"]``, where there is one, layer-stacked (leading
    axis ``encoder_layers``); the port holds one dict per period and per
    encoder layer.  The other top-level leaves (``embed``, ``lm_head``,
    the norms, a VLM's ``vis_proj``) come across as they are.  A bf16
    array arrives as fp32 or as its ``uint16`` bit patterns; every leaf
    is cast to ``cfg.param_dtype`` (those named in :data:`FP32_LEAVES` to
    fp32, as the reference keeps them) and placed on ``device`` (default
    CUDA, which raises without a card; pass ``device="cpu"`` for the
    CPU).
    """
    import torch

    from repro_torch.kernels.ops import resolve_device

    device = resolve_device(device)

    dtype = {"bfloat16": torch.bfloat16,
             "float32": torch.float32}[cfg.param_dtype]

    def leaf(a, name):
        a = np.require(a, requirements=["C", "W"])
        if a.dtype == np.uint16:
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        elif a.dtype == np.float32:
            t = torch.from_numpy(a)
        else:
            raise ValueError(f"weights arrive as float32 or uint16 bf16 "
                             f"bits, not {a.dtype}")
        return t.to(device=device, dtype=torch.float32
                    if name in FP32_LEAVES else dtype)

    def walk(node, period=None, name=None):
        if isinstance(node, dict):
            return {k: walk(v, period, k) for k, v in node.items()}
        return leaf(node if period is None else node[period], name)

    stacks = {"blocks": cfg.num_periods, "encoder": cfg.encoder_layers}
    out = {k: walk(v, name=k) for k, v in tree.items() if k not in stacks}
    for k, n in stacks.items():
        if k in tree:
            out[k] = [walk(tree[k], i) for i in range(n)]
    return out


def lm_params_to_arrays(tree: dict) -> dict:
    """The inverse of :func:`lm_params_from_arrays`: the port's LM
    parameters (or a tree of their shape, such as the optimizer's
    moments) as numpy arrays in the reference's layout.

    Each list (``blocks``, one dict per period; ``encoder``, one per
    encoder layer) is stacked leaf by leaf along a new leading axis, the
    reference's vmapped stacks.  A bf16 leaf leaves as its ``uint16`` bit
    patterns, an fp32 leaf as float32; each is a copy on the host.
    """
    import torch

    def leaf(t):
        t = t.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        if t.dtype == torch.float32:
            return t.numpy()
        raise ValueError(f"weights leave as float32 or bf16, not {t.dtype}")

    def stack(items):
        if isinstance(items[0], dict):
            return {k: stack([it[k] for it in items]) for k in items[0]}
        return np.stack(items)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return stack([walk(e) for e in node])
        return leaf(node)

    return walk(tree)
