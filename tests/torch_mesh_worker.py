"""Rank functions of ``tests/test_torch_mesh_spmv.py``.

Each runs on every rank of a world that
``repro_torch.launch.mesh.run_world`` starts (``gloo`` over CPU tensors),
and imports torch and the port only: the reference runs in a process of
its own.
"""
import time

import pytest
import torch
import torch.distributed as dist

from repro_torch.core import format as TF
from repro_torch.core import partition as TP
from repro_torch.core import spmv as tspmv
from repro_torch.launch import mesh as tmesh
from torch.distributed.device_mesh import init_device_mesh

# name -> (mesh shape, dimension names, the axis the operator shards on).
MESHES = {"x2": ((2,), ("x",), "x"), "x4": ((4,), ("x",), "x"),
          "dm2x2": ((2, 2), ("data", "model"), "model")}


def make_mesh(name):
    shape, names, axis = MESHES[name]
    if names == ("data", "model"):
        return tmesh.make_host_mesh(*shape), axis
    return init_device_mesh("cpu", shape, mesh_dim_names=names), axis


def build(case, part, mesh, axis, data):
    """The case's operator over ``mesh``/``axis``, built on every rank."""
    cfg = TF.SerpensConfig(**case["config"])
    rows = data["rows_hot"] if case["hot"] else data["rows"]
    cols, vals, shape = data["cols"], data["vals"], tuple(data["shape"])
    n = mesh.get_group(axis).size()
    if case["via"] == "sharded":
        return tspmv.ShardedSerpensSpMV(rows, cols, vals, shape, mesh, axis,
                                        part, cfg, device="cpu")
    if case["via"] == "operator":
        plan = TP.make_plan(rows, cols, vals, shape, cfg,
                            TP.PlanSpec(part, n, case["lane_assign"]))
        return tspmv.SerpensOperator(plan, device="cpu", mesh=mesh,
                                     axis=axis)
    one = tspmv.SerpensSpMV(rows, cols, vals, shape, cfg, device="cpu")
    return one.with_mesh(mesh, axis, part)


def apply(op, what, data):
    """One of the cases' products: ``mv`` = A·x, ``call`` = 1.5·A·x +
    0.5·y, ``mm`` = A·X, ``mmab`` = -0.5·A·X + 2·Y (X, Y with N = 4)."""
    if what == "mv":
        return op.matvec(data["x"])
    if what == "call":
        return op(data["x"], 1.5, 0.5, data["y"])
    if what == "mm":
        return op.matmat(data["xm"])
    return op.matmat(data["xm"], -0.5, 2.0, data["ym"])


def one_process_bytes(op):
    """device_bytes of the one-process operator on the same plan."""
    return tspmv.SerpensOperator(op.plan, device="cpu").device_bytes


def refusals(mesh, axis, data):
    """The mesh path's refusals, each with its message (2-rank world)."""
    base = {"segment_width": 128, "lanes": 16, "sublanes": 8}
    cfg = TF.SerpensConfig(**base)
    shape = tuple(data["shape"])
    args = (data["rows"], data["cols"], data["vals"], shape)
    plan3 = TP.make_plan(*args, cfg, TP.PlanSpec("row", 3))
    seen = {}

    def refused(name, fn, match):
        with pytest.raises(ValueError, match=match) as info:
            fn()
        seen[name] = str(info.value)

    refused("mesh_without_axis", lambda: tspmv.SerpensOperator(
        plan3, device="cpu", mesh=mesh), "must be given together")
    refused("axis_without_mesh", lambda: tspmv.SerpensOperator(
        plan3, device="cpu", axis=axis), "must be given together")
    refused("axis_size", lambda: tspmv.SerpensOperator(
        plan3, device="cpu", mesh=mesh, axis=axis),
        f"plan has 3 shards but mesh axis '{axis}' has 2 devices")
    refused("unknown_axis", lambda: tspmv.SerpensOperator(
        plan3, device="cpu", mesh=mesh, axis="y"), "no axis 'y'")
    one = tspmv.SerpensSpMV(*args, cfg, device="cpu")
    refused("with_mesh_without_axis", lambda: one.with_mesh(mesh, None),
            "mesh requires axis")
    refused("partition", lambda: tspmv.ShardedSerpensSpMV(
        *args, mesh, axis, "diag", cfg, device="cpu"),
        "partition must be 'row' or 'col'")
    op = tspmv.ShardedSerpensSpMV(*args, mesh, axis, "row", cfg,
                                  device="cpu")
    seen["supports_fused_epilogue"] = op.supports_fused_epilogue
    refused("matvec_fused", lambda: op.matvec_fused(
        data["x"], lambda acc: (acc,)), r"mesh-free plan .*mesh=True")
    seen["with_mesh_none_is_self"] = one.with_mesh(None, axis) is one
    return seen


def run_cases(rank, world_size, mesh_name, cases, data, check_refusals):
    """Every case on both partitions over one mesh: each product as numpy,
    and each operator's shards, aux spill and byte count."""
    torch.manual_seed(0)
    mesh, axis = make_mesh(mesh_name)
    out = {"coord": mesh.get_local_rank(axis),
           "dp_axes": tmesh.dp_axes(mesh)}
    for part in ("row", "col"):
        for name, case in cases.items():
            op = build(case, part, mesh, axis, data)
            key = f"{part}/{name}"
            for what in case["ops"]:
                got = apply(op, what, data)
                assert got.dtype == torch.float32
                out[f"{key}/{what}"] = got.numpy()
            out[f"{key}/num_shards"] = op.plan.num_shards
            out[f"{key}/partition"] = op.plan.spec.partition
            out[f"{key}/n_aux"] = op.plan.n_aux
            out[f"{key}/row_perm"] = op.plan.row_perm is not None
            out[f"{key}/device_bytes"] = op.device_bytes
            out[f"{key}/one_process_bytes"] = one_process_bytes(op)
            out[f"{key}/held_shards"] = len(op._shards)
    if check_refusals:
        out["refusals"] = refusals(mesh, axis, data)
    return out


def wait_forever(rank, world_size):
    """A rank that never returns (the deadline's test)."""
    time.sleep(3600)


def fail_on_rank_1(rank, world_size):
    """Rank 1 raises; rank 0 waits for it in a barrier that never ends."""
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    dist.barrier()
