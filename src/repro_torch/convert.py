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
there).  This module imports numpy only; torch is imported inside the
function that needs it.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import format as sformat
from repro_torch.core import partition as cpart


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

    ``tree["blocks"]`` is period-stacked (leading axis ``num_periods``);
    the port holds one dict per period.  A bf16 array arrives as fp32 or
    as its ``uint16`` bit patterns; every leaf is cast to
    ``cfg.param_dtype`` and placed on ``device`` (default CUDA, which
    raises without a card; pass ``device="cpu"`` for the CPU).
    """
    import torch

    from repro_torch.kernels.ops import resolve_device

    device = resolve_device(device)

    dtype = {"bfloat16": torch.bfloat16,
             "float32": torch.float32}[cfg.param_dtype]

    def leaf(a):
        a = np.require(a, requirements=["C", "W"])
        if a.dtype == np.uint16:
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        elif a.dtype == np.float32:
            t = torch.from_numpy(a)
        else:
            raise ValueError(f"weights arrive as float32 or uint16 bf16 "
                             f"bits, not {a.dtype}")
        return t.to(device=device, dtype=dtype)

    def walk(node, period=None):
        if isinstance(node, dict):
            return {k: walk(v, period) for k, v in node.items()}
        return leaf(node if period is None else node[period])

    out = {k: walk(v) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [walk(tree["blocks"], p) for p in range(cfg.num_periods)]
    return out
