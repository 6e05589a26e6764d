"""Rank functions of ``tests/test_torch_mesh_spmv.py`` and
``tests/test_torch_mesh_serve.py``.

Each runs on every rank of a world that
``repro_torch.launch.mesh.run_world`` starts (``gloo`` over CPU tensors),
and imports torch and the port only: the reference runs in a process of
its own.
"""
import time

import numpy as np
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


# -- tests/test_torch_mesh_serve.py: the registry, service and solvers -------
def plain(y):
    """A result as a numpy array (results of the service already are)."""
    return y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


def stats_of(reg):
    s = reg.stats_snapshot()
    return {f: getattr(s, f) for f in STAT_FIELDS}


STAT_FIELDS = ("hits", "misses", "encodes", "evictions", "prepared_drops",
               "bindings_dropped", "background_puts", "delta_encodes")


def serve_requests(svc, mid, data):
    """The requests of ``data`` through one flush, then a lone request
    through another: y's in submit order, each result's (batch size,
    bucket width), the lone y and its shape, and the service counters."""
    out = {}
    tickets = []
    for i in range(len(data["alphas"])):
        beta = float(data["betas"][i])
        tickets.append(svc.submit(
            mid, data["xs"][i], alpha=float(data["alphas"][i]), beta=beta,
            y=data["ys"][i] if beta != 0.0 else None))
    res = svc.flush()
    out["y"] = np.stack([plain(res[t].y) for t in tickets])
    out["batch"] = np.array([(res[t].batch_size, res[t].bucket_n)
                             for t in tickets])
    lone = svc.submit(mid, data["x"], alpha=1.5, beta=0.5, y=data["y"])
    r = svc.flush()[lone]
    out["lone"] = plain(r.y)
    out["lone_batch"] = np.array([r.batch_size, r.bucket_n])
    out["batches"] = svc.stats.batches
    out["vectors"] = svc.stats.vectors
    op = svc._get_op(mid)
    out["plan"] = (op.plan.spec.partition, op.plan.num_shards,
                   len(op._shards))
    return out


def pressure_steps(reg, data, mesh, axis):
    """Byte pressure: A put and bound to the mesh axis, then B put (A's
    bindings shed), A's mesh binding asked again (B's shed), then B's.
    Returns the stats after every step."""
    a = reg.put(data["rows"], data["cols"], data["vals"],
                tuple(data["shape"]))
    steps = [stats_of(reg)]
    reg.get(a, mesh=mesh, axis=axis)
    steps.append(stats_of(reg))
    b = reg.put(data["rows_b"], data["cols_b"], data["vals_b"],
                tuple(data["shape"]))
    steps.append(stats_of(reg))
    reg.get(a, mesh=mesh, axis=axis)
    steps.append(stats_of(reg))
    reg.get(b)
    steps.append(stats_of(reg))
    return steps


def scaled_clock(factor):
    """A stand-in for the pipeline module's ``time`` whose perf_counter
    runs ``factor`` times as fast: every duration it measures is scaled."""
    import types
    real = time.perf_counter
    return types.SimpleNamespace(perf_counter=lambda: real() * factor)


def autotune_run(rank, mesh, axis, data, agree: bool):
    """An auto-tuned entry served with retune_every=1 over the mesh, rank
    1's clock three times as fast as the others'.  Returns the tuner's
    snapshot and the entry's plan after the dispatches (with ``agree``
    False the pipeline's agreement is bypassed, for one dispatch only)."""
    from repro_torch.core.registry import MatrixRegistry
    from repro_torch.serve import pipeline as tpipe
    from repro_torch.serve.spmv_service import SpMVService

    cfg = TF.SerpensConfig(segment_width=128, lanes=16, sublanes=8)
    reg = MatrixRegistry(config=cfg, device="cpu")
    mid = reg.put(data["rows"], data["cols"], data["vals"],
                  tuple(data["shape"]), spec="auto")
    svc = SpMVService(reg, max_bucket=4, mesh=mesh, axis=axis,
                      retune_every=1, device="cpu")
    real_time = tpipe.time
    if rank == 1:
        tpipe.time = scaled_clock(3.0)
    if not agree:
        svc._agreed_seconds = lambda op, seconds: seconds
    try:
        for r in range(1 if not agree else 4):
            for i in range(4):
                svc.submit(mid, data["xs"][i])
            svc.flush()
    finally:
        tpipe.time = real_time
    stats = reg.encode_stats()[mid]
    return {"tuner": reg.tuner.snapshot(), "spec": stats["spec"],
            "tune": stats["tune"],
            "plan": reg.get(mid, mesh=mesh, axis=axis).plan.spec}


def serve_cases(rank, world_size, mesh_name, data, budget, extras):
    """The registry, the service and the solvers over one mesh, as the
    reference's script runs them; with ``extras`` also the port's own
    checks (refusals, the deferred request, the prepared and decode
    repartitions, the auto-tuned entry, mesh identity)."""
    from repro_torch import solvers
    from repro_torch.core.registry import MatrixRegistry
    from repro_torch.core.spmv import SerpensSpMV
    from repro_torch.serve.spmv_service import SpMVService

    torch.manual_seed(0)
    mesh, axis = make_mesh(mesh_name)
    cfg = TF.SerpensConfig(segment_width=128, lanes=16, sublanes=8)
    args = (data["rows"], data["cols"], data["vals"], tuple(data["shape"]))
    out = {}

    # Registry: a single-shard put, repartitioned once on get.
    reg = MatrixRegistry(config=cfg, device="cpu")
    mid = reg.put(*args)
    encodes = [reg.stats.encodes]
    op = reg.get(mid, mesh=mesh, axis=axis)
    encodes.append(reg.stats.encodes)
    out["reg/same"] = reg.get(mid, mesh=mesh, axis=axis) is op
    encodes.append(reg.stats.encodes)
    opc = reg.get(mid, mesh=mesh, axis=axis, partition="col")
    encodes.append(reg.stats.encodes)
    out["reg/encodes"] = encodes
    out["reg/specs"] = [str(op.plan.spec), str(opc.plan.spec)]
    for part, o in (("row", op), ("col", opc)):
        out[f"reg/{part}/plan"] = (o.plan.idx, o.plan.val, o.plan.seg_ids)
    out["reg/row/call"] = plain(op(data["x"], 1.5, 0.5, data["y"]))
    out["reg/col/call"] = plain(opc(data["x"], 1.5, 0.5, data["y"]))
    out["reg/plans"] = len(reg._entries[mid].plans)
    out["reg/stats"] = stats_of(reg)
    out["reg/device_bytes"] = reg.device_bytes_in_use

    # The service over the mesh, on the registry's binding.
    for part in ("row", "col"):
        svc = SpMVService(reg, max_bucket=4, mesh=mesh, axis=axis,
                          partition=None if part == "row" else part,
                          device="cpu")
        for k, v in serve_requests(svc, mid, data).items():
            out[f"svc/{part}/{k}"] = v

    # Solvers: mesh= on the solver, and solves through the service.
    spd = SerpensSpMV(data["spd_r"], data["spd_c"], data["spd_v"],
                      tuple(data["spd_shape"]), cfg, device="cpu")
    cg = solvers.conjugate_gradient(spd, data["b"], tol=1e-6, mesh=mesh,
                                    axis=axis)
    gop = SerpensSpMV(data["g_r"], data["g_c"], data["g_v"],
                      tuple(data["g_shape"]), cfg, device="cpu")
    pr = solvers.pagerank(gop, tol=1e-9, mesh=mesh, axis=axis)
    gap = SerpensSpMV(data["gap_r"], data["gap_c"], data["gap_v"],
                      tuple(data["gap_shape"]), cfg, device="cpu")
    pw = solvers.power_iteration(gap, tol=1e-6, max_iters=100, mesh=mesh,
                                 axis=axis)
    for name, res in (("cg", cg), ("pr", pr), ("pw", pw)):
        out[f"{name}/iters"] = res.iterations
        out[f"{name}/x"] = plain(res.x)
        out[f"{name}/fused"] = res.fused
    out["pw/lam"] = pw.eigenvalue
    gmid = reg.put(data["g_r"], data["g_c"], data["g_v"],
                   tuple(data["g_shape"]))
    smid = reg.put(data["spd_r"], data["spd_c"], data["spd_v"],
                   tuple(data["spd_shape"]))
    svc = SpMVService(reg, max_bucket=4, mesh=mesh, axis=axis, device="cpu")
    for name, res in (("svc_pr", svc.solve(gmid, "pagerank", tol=1e-9)),
                      ("svc_cg", svc.solve(smid, "cg", b=data["b"],
                                           tol=1e-6))):
        out[f"{name}/iters"] = res.solve.iterations
        out[f"{name}/x"] = res.y

    # update() re-splices every cached plan and drops the mesh bindings.
    ureg = MatrixRegistry(config=cfg, device="cpu")
    umid = ureg.put(*args)
    before = ureg.get(umid, mesh=mesh, axis=axis)
    ureg.update(umid, data["dr"], data["dc"], data["dv"])
    out["upd/plans"] = {str(spec): (p.idx, p.val, p.seg_ids)
                        for spec, p in ureg._entries[umid].plans.items()}
    after = ureg.get(umid, mesh=mesh, axis=axis)
    out["upd/rebound"] = after is not before
    out["upd/call"] = plain(after(data["x"], 1.5, 0.5, data["y"]))
    out["upd/old_call"] = plain(before(data["x"], 1.5, 0.5, data["y"]))

    # Byte pressure.
    preg = MatrixRegistry(config=cfg, device="cpu", byte_budget=budget)
    out["pressure"] = pressure_steps(preg, data, mesh, axis)
    out["pressure/device_bytes"] = preg.device_bytes_in_use
    if extras:
        out.update(serve_extras(rank, mesh, axis, data, cfg, args))
    return out


def serve_extras(rank, mesh, axis, data, cfg, args):
    """The port's own checks of the mesh path (2-rank world)."""
    from repro_torch import solvers
    from repro_torch.core.registry import MatrixRegistry
    from repro_torch.core.spmv import SerpensOperator
    from repro_torch.serve.spmv_service import SpMVService

    out = {}
    reg = MatrixRegistry(config=cfg, device="cpu")
    mid = reg.put(*args)
    # Two meshes made alike over the same world are one binding key.
    again, _ = make_mesh("x2")
    out["mesh_equal"] = again == mesh and hash(again) == hash(mesh)
    out["same_binding"] = reg.get(mid, mesh=mesh, axis=axis) is reg.get(
        mid, mesh=again, axis=axis)
    # Refusals.
    seen = {}

    def refused(name, exc, fn, match):
        with pytest.raises(exc, match=match) as info:
            fn()
        seen[name] = str(info.value)

    refused("get_partition_without_mesh", ValueError,
            lambda: reg.get(mid, partition="col"), "partition requires")
    refused("get_mesh_without_axis", ValueError,
            lambda: reg.get(mid, mesh=mesh), "mesh requires axis")
    refused("svc_mesh_without_axis", ValueError,
            lambda: SpMVService(reg, mesh=mesh, device="cpu"),
            "mesh requires axis")
    refused("svc_partition_without_mesh", ValueError,
            lambda: SpMVService(reg, partition="col", device="cpu"),
            "partition requires mesh")
    svc = SpMVService(reg, max_bucket=4, mesh=mesh, axis=axis, device="cpu")
    refused("start", NotImplementedError, svc.start, "#8")
    spd = reg.get(reg.put(data["spd_r"], data["spd_c"], data["spd_v"],
                          tuple(data["spd_shape"])))
    refused("fused", ValueError, lambda: solvers.conjugate_gradient(
        spd, data["b"], mesh=mesh, axis=axis, fused=True),
        r"cannot fuse \(multi-shard, mesh-bound")
    out["refusals"] = seen
    # A request against a put(blocking=False) entry dispatches at the
    # first flush on every rank.
    dmid = reg.put(data["rows_b"], data["cols_b"], data["vals_b"],
                   tuple(data["shape"]), blocking=False)
    t = svc.submit(dmid, data["x"], alpha=1.5, beta=0.5, y=data["y"])
    res = svc.flush()
    out["deferred/served"] = t in res
    out["deferred/y"] = res[t].y if t in res else None
    out["deferred/count"] = svc.stats.deferred
    # The prepared sort serves the repartition: no stream is decoded.
    real = TP.ChannelShardPlan.to_coo

    def boom(self):
        raise AssertionError("repartition decoded the stream")

    preg = MatrixRegistry(config=cfg, device="cpu")
    pmid = preg.put(*args)
    TP.ChannelShardPlan.to_coo = boom
    try:
        pop = preg.get(pmid, mesh=mesh, axis=axis)
    finally:
        TP.ChannelShardPlan.to_coo = real
    out["prepared/encodes"] = preg.stats.encodes
    out["prepared/call"] = plain(pop(data["x"], 1.5, 0.5, data["y"]))
    # An adopted operator has no prepared sort: its stream is decoded.
    areg = MatrixRegistry(config=cfg, device="cpu")
    one = SerpensOperator(TP.make_plan(*args, cfg, TP.PlanSpec()),
                          device="cpu")
    amid = areg.put_operator(one)
    decoded = []
    TP.ChannelShardPlan.to_coo = lambda self: decoded.append(1) or real(self)
    try:
        aop = areg.get(amid, mesh=mesh, axis=axis)
    finally:
        TP.ChannelShardPlan.to_coo = real
    out["adopted/decoded"] = len(decoded)
    out["adopted/encodes"] = areg.stats.encodes
    out["adopted/spec"] = str(aop.plan.spec)
    out["adopted/call"] = plain(aop(data["x"], 1.5, 0.5, data["y"]))
    # Tuner feedback agreed across ranks, and without the agreement.
    out["auto"] = autotune_run(rank, mesh, axis, data, agree=True)
    out["auto_unagreed"] = autotune_run(rank, mesh, axis, data, agree=False)
    return out
