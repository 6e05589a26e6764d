"""The port's registry, service and solvers over a ``DeviceMesh`` against
the reference's ``shard_map`` runs.

The reference runs in a subprocess with four host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
``tests/test_distributed.py`` runs it), one for each mesh, all at once:
``MatrixRegistry.get(mid, mesh=, axis=, partition=)`` with its
repartition-on-get, ``SpMVService(reg, mesh=, axis=, partition=)``,
``conjugate_gradient``, ``pagerank`` and ``power_iteration`` with
``mesh=``/``axis=`` and through the service, ``update`` of an entry with
a mesh plan cached, and byte pressure that sheds mesh bindings, over a
2- and a 4-device ``x`` axis and the ``model`` axis of a ``(2, 2)``
``("data", "model")`` mesh.  The port runs the same calls in one ``gloo``
world of fresh processes for each mesh
(``repro_torch.launch.mesh.run_world``; the rank functions are in
``tests/torch_mesh_worker.py``), every rank holding one shard.  Products
are held to the reference's within rtol = atol = 2e-5 (the reference's own
tolerance, ``tests/test_distributed.py``), solves to equal iteration
counts and x within the solver tests' rtol = atol = 1e-5, and every rank
to every other rank bit for bit.  Each world and the reference run under a
deadline; past it they are killed and the fixture fails.
"""
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from repro_torch.data import matrices as TM
from repro_torch.launch import mesh as tmesh

import torch_mesh_worker as worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-5, atol=2e-5)
SOLVE_TOL = dict(rtol=1e-5, atol=1e-5)
WORLD_TIMEOUT_S = 180.0
REF_TIMEOUT_S = 300.0
BASE = {"segment_width": 128, "lanes": 16, "sublanes": 8}
WORLDS = {"x2": 2, "x4": 4, "dm2x2": 4}
# The size of each mesh's operator axis.
AXIS_SIZE = {"x2": 2, "x4": 4, "dm2x2": 2}

REFERENCE = r"""
import json, sys
import numpy as np
from repro import compat, solvers
from repro.core import format as F
from repro.core.registry import MatrixRegistry
from repro.core.spmv import SerpensSpMV
from repro.serve.spmv_service import SpMVService

inp = dict(np.load(sys.argv[1]))
budgets = json.load(open(sys.argv[2]))
mname = sys.argv[4]
shape, names, axis = {"x2": ((2,), ("x",), "x"), "x4": ((4,), ("x",), "x"),
                      "dm2x2": ((2, 2), ("data", "model"), "model")}[mname]
mesh = compat.make_mesh(shape, names)
cfg = F.SerpensConfig(segment_width=128, lanes=16, sublanes=8)
args = (inp["rows"], inp["cols"], inp["vals"], tuple(inp["shape"]))
FIELDS = ("hits", "misses", "encodes", "evictions", "prepared_drops",
          "bindings_dropped", "background_puts", "delta_encodes")
out = {}


def put(key, value):
    out[f"{mname}/{key}"] = np.asarray(value)


def stats(reg):
    return [getattr(reg.stats, f) for f in FIELDS]


reg = MatrixRegistry(config=cfg, backend="xla")
mid = reg.put(*args)
enc = [reg.stats.encodes]
op = reg.get(mid, mesh=mesh, axis=axis)
enc.append(reg.stats.encodes)
put("reg/same", reg.get(mid, mesh=mesh, axis=axis) is op)
enc.append(reg.stats.encodes)
opc = reg.get(mid, mesh=mesh, axis=axis, partition="col")
enc.append(reg.stats.encodes)
put("reg/encodes", enc)
put("reg/specs", [str(op.plan.spec), str(opc.plan.spec)])
for part, o in (("row", op), ("col", opc)):
    for a in ("idx", "val", "seg_ids"):
        put(f"reg/{part}/{a}", getattr(o.plan, a))
put("reg/row/call", op(inp["x"], 1.5, 0.5, inp["y"]))
put("reg/col/call", opc(inp["x"], 1.5, 0.5, inp["y"]))
put("reg/plans", len(reg._entries[mid].plans))
put("reg/stats", stats(reg))

for part in ("row", "col"):
    svc = SpMVService(reg, max_bucket=4, mesh=mesh, axis=axis,
                      partition=None if part == "row" else part)
    tickets = []
    for i in range(len(inp["alphas"])):
        beta = float(inp["betas"][i])
        tickets.append(svc.submit(
            mid, inp["xs"][i], alpha=float(inp["alphas"][i]), beta=beta,
            y=inp["ys"][i] if beta != 0.0 else None))
    res = svc.flush()
    put(f"svc/{part}/y", np.stack([res[t].y for t in tickets]))
    put(f"svc/{part}/batch", [(res[t].batch_size, res[t].bucket_n)
                              for t in tickets])
    lone = svc.submit(mid, inp["x"], alpha=1.5, beta=0.5, y=inp["y"])
    r = svc.flush()[lone]
    put(f"svc/{part}/lone", r.y)
    put(f"svc/{part}/lone_batch", [r.batch_size, r.bucket_n])
    put(f"svc/{part}/batches", svc.stats.batches)
    put(f"svc/{part}/vectors", svc.stats.vectors)

spd = SerpensSpMV(inp["spd_r"], inp["spd_c"], inp["spd_v"],
                  tuple(inp["spd_shape"]), cfg, backend="xla")
gop = SerpensSpMV(inp["g_r"], inp["g_c"], inp["g_v"],
                  tuple(inp["g_shape"]), cfg, backend="xla")
gap = SerpensSpMV(inp["gap_r"], inp["gap_c"], inp["gap_v"],
                  tuple(inp["gap_shape"]), cfg, backend="xla")
for name, res in (
        ("cg", solvers.conjugate_gradient(spd, inp["b"], tol=1e-6,
                                          mesh=mesh, axis=axis)),
        ("pr", solvers.pagerank(gop, tol=1e-9, mesh=mesh, axis=axis)),
        ("pw", solvers.power_iteration(gap, tol=1e-6, max_iters=100,
                                       mesh=mesh, axis=axis))):
    put(f"{name}/iters", res.iterations)
    put(f"{name}/x", res.x)
    put(f"{name}/fused", res.fused)
    if name == "pw":
        put("pw/lam", res.eigenvalue)
gmid = reg.put(inp["g_r"], inp["g_c"], inp["g_v"], tuple(inp["g_shape"]))
smid = reg.put(inp["spd_r"], inp["spd_c"], inp["spd_v"],
               tuple(inp["spd_shape"]))
svc = SpMVService(reg, max_bucket=4, mesh=mesh, axis=axis)
for name, res in (("svc_pr", svc.solve(gmid, "pagerank", tol=1e-9)),
                  ("svc_cg", svc.solve(smid, "cg", b=inp["b"], tol=1e-6))):
    put(f"{name}/iters", res.solve.iterations)
    put(f"{name}/x", res.y)

ureg = MatrixRegistry(config=cfg, backend="xla")
umid = ureg.put(*args)
ureg.get(umid, mesh=mesh, axis=axis)
ureg.update(umid, inp["dr"], inp["dc"], inp["dv"])
for spec, p in ureg._entries[umid].plans.items():
    for a in ("idx", "val", "seg_ids"):
        put(f"upd/{spec}/{a}", getattr(p, a))
put("upd/call", ureg.get(umid, mesh=mesh, axis=axis)(
    inp["x"], 1.5, 0.5, inp["y"]))

preg = MatrixRegistry(config=cfg, backend="xla",
                      byte_budget=budgets[mname])
a = preg.put(*args)
steps = [stats(preg)]
preg.get(a, mesh=mesh, axis=axis)
steps.append(stats(preg))
b = preg.put(inp["rows_b"], inp["cols_b"], inp["vals_b"],
             tuple(inp["shape"]))
steps.append(stats(preg))
preg.get(a, mesh=mesh, axis=axis)
steps.append(stats(preg))
preg.get(b)
steps.append(stats(preg))
put("pressure", steps)
np.savez(sys.argv[3], **out)
"""


def spd(n=56, seed=6):
    """Sparse symmetric diagonally-dominant (hence SPD) matrix and a b
    (``tests/test_torch_solvers.py``'s)."""
    rng = np.random.default_rng(seed)
    a = np.zeros((n, n), np.float32)
    idx = rng.integers(0, n, (4 * n, 2))
    a[idx[:, 0], idx[:, 1]] = rng.normal(size=4 * n)
    a = (a + a.T) / 2
    a[np.arange(n), np.arange(n)] = np.abs(a).sum(1) + 1.0
    rows, cols = np.nonzero(a)
    return rows, cols, a[rows, cols], rng.normal(size=n).astype(np.float32)


def gapped(n=48, seed=5):
    """SPD with a well-separated top eigenvalue (power iteration)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    w = np.linspace(1.0, 2.0, n)
    w[-1] = 4.0
    a = ((q * w) @ q.T).astype(np.float32)
    a[np.abs(a) < 0.02] = 0.0
    rows, cols = np.nonzero(a)
    return rows, cols, a[rows, cols]


def make_data():
    rng = np.random.default_rng(0)
    rows, cols, vals = TM.uniform_random(600, 800, 5000, seed=1)
    rows_b, cols_b, vals_b = TM.uniform_random(600, 800, 5000, seed=2)
    n_req = 11
    betas = rng.uniform(-1.0, 1.0, n_req).astype(np.float32)
    betas[::3] = 0.0                      # some requests carry no y
    spd_r, spd_c, spd_v, b = spd()
    g_r, g_c, g_v = TM.power_law_graph(60, 400, seed=20)
    gap_r, gap_c, gap_v = gapped()
    return {
        "rows": rows, "cols": cols, "vals": vals, "shape": np.array([600, 800]),
        "rows_b": rows_b, "cols_b": cols_b, "vals_b": vals_b,
        "x": rng.normal(size=800).astype(np.float32),
        "y": rng.normal(size=600).astype(np.float32),
        "xs": rng.normal(size=(n_req, 800)).astype(np.float32),
        "ys": rng.normal(size=(n_req, 600)).astype(np.float32),
        "alphas": rng.uniform(-2.0, 2.0, n_req).astype(np.float32),
        "betas": betas,
        "spd_r": spd_r, "spd_c": spd_c, "spd_v": spd_v,
        "spd_shape": np.array([56, 56]), "b": b,
        "g_r": g_r, "g_c": g_c,
        "g_v": TM.column_normalize(g_r, g_c, g_v, 60),
        "g_shape": np.array([60, 60]),
        "gap_r": gap_r, "gap_c": gap_c, "gap_v": gap_v,
        "gap_shape": np.array([48, 48]),
        "dr": rng.integers(0, 600, 12), "dc": rng.integers(0, 800, 12),
        "dv": rng.normal(size=12).astype(np.float32)}


def pressure_budget(data, n: int) -> int:
    """A byte budget under which both packages take the same shedding
    decisions in ``pressure_steps``: A (a put, its ``row:n`` plan and mesh
    binding) and B (a put) fit, with every binding but one (whichever was
    asked for last).  Each package's bytes are counted on its own
    operators (the reference's mesh binding holds the stacked shards and
    the Pallas kernel's per-chunk segment ids, the port's the shards)."""
    from repro.core import format as RF
    from repro.core import partition as RP
    from repro.core import registry as RR
    from repro_torch.core import format as TF
    from repro_torch.core import partition as TP
    from repro_torch.core import registry as TR
    from repro_torch.core import spmv as tspmv

    a = (data["rows"], data["cols"], data["vals"], tuple(data["shape"]))
    b = (data["rows_b"], data["cols_b"], data["vals_b"], tuple(data["shape"]))
    bounds = []
    for reg, part in (
            (TR.MatrixRegistry(config=TF.SerpensConfig(**BASE), device="cpu",
                               byte_budget=1 << 40), TP),
            (RR.MatrixRegistry(config=RF.SerpensConfig(**BASE),
                               backend="xla", byte_budget=1 << 40), RP)):
        ea = reg._entries[reg.put(*a)]
        plan = part.plan_from_prepared(ea.prepared, part.PlanSpec("row", n))
        if part is TP:
            mesh_bytes = tspmv.SerpensOperator(plan, device="cpu").device_bytes
        else:
            mesh_bytes = sum(int(x.nbytes) for x in (
                plan.idx, plan.val, plan.seg_ids,
                plan.seg_ids[:, ::plan.config.tiles_per_chunk],
                plan.aux_rows, plan.aux_cols, plan.aux_vals))
        eb = reg._entries[reg.put(*b)]
        base = (ea.stream_bytes + ea.prepared_bytes + plan.stream_bytes
                + eb.stream_bytes + eb.prepared_bytes)
        bounds.append((base + max(eb.device_bytes, mesh_bytes),
                       base + eb.device_bytes + mesh_bytes))
    lo, hi = max(lo for lo, _ in bounds), min(hi for _, hi in bounds)
    assert lo < hi, bounds
    return lo


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each world's per-rank results, the reference's outputs, the
    budgets).  The reference's subprocesses run while the port's worlds
    do."""
    d = tmp_path_factory.mktemp("mesh_serve")
    data = make_data()
    budgets = {name: pressure_budget(data, AXIS_SIZE[name])
               for name in WORLDS}
    np.savez(d / "inputs.npz", **data)
    (d / "budgets.json").write_text(json.dumps(budgets))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    refs = {name: subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(d / "inputs.npz"),
         str(d / "budgets.json"), str(d / f"ref_{name}.npz"), name],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name in WORLDS}
    deadline = time.monotonic() + REF_TIMEOUT_S
    try:
        port = {}
        for name, world in WORLDS.items():
            wd = d / name
            wd.mkdir()
            port[name] = tmesh.run_world(
                "torch_mesh_worker:serve_cases", world,
                (name, data, budgets[name], name == "x2"), workdir=str(wd),
                timeout_s=WORLD_TIMEOUT_S)
        errs = {name: ref.communicate(
            timeout=max(1.0, deadline - time.monotonic()))[1]
            for name, ref in refs.items()}
    finally:
        for ref in refs.values():
            if ref.poll() is None:
                ref.kill()
            ref.wait()
    reference = {}
    for name, ref in refs.items():
        assert ref.returncode == 0, errs[name][-4000:]
        with np.load(d / f"ref_{name}.npz") as f:
            reference.update(f)
    return port, reference, data


def bit_equal(ranks, key):
    first = np.asarray(ranks[0][key])
    for r in ranks[1:]:
        assert np.asarray(r[key]).tobytes() == first.tobytes(), key
    return first


@pytest.mark.parametrize("mesh", sorted(WORLDS))
def test_registry_repartitions_once_on_get(runs, mesh):
    """A single-shard put is repartitioned to ``row:n`` on the first mesh
    get (encodes 1 → 2), cached thereafter (the same operator, no
    encode), and ``partition="col"`` adds a second plan and binding — the
    reference's counts, plans and products (tests/test_distributed.py)."""
    port, ref, _ = runs
    n = AXIS_SIZE[mesh]
    for r in port[mesh]:
        assert r["reg/encodes"] == [1, 2, 2, 3]
        assert r["reg/encodes"] == list(ref[f"{mesh}/reg/encodes"])
        assert r["reg/same"] and bool(ref[f"{mesh}/reg/same"])
        assert r["reg/specs"] == list(ref[f"{mesh}/reg/specs"])
        assert f"num_shards={n}" in r["reg/specs"][0]
        assert r["reg/plans"] == int(ref[f"{mesh}/reg/plans"]) == 3
        assert [r["reg/stats"][f] for f in worker.STAT_FIELDS] == \
            list(ref[f"{mesh}/reg/stats"])
    for part in ("row", "col"):
        # The repartitioned plan: the same bytes on every rank and in the
        # reference (a deterministic encode from the same prepared sort).
        for r in port[mesh]:
            for name, a in zip(("idx", "val", "seg_ids"),
                               r[f"reg/{part}/plan"]):
                want = ref[f"{mesh}/reg/{part}/{name}"]
                assert a.dtype == want.dtype
                assert a.tobytes() == want.tobytes(), (part, name)
        got = bit_equal(port[mesh], f"reg/{part}/call")
        np.testing.assert_allclose(got, ref[f"{mesh}/reg/{part}/call"], **TOL)
    assert len({r["reg/device_bytes"] for r in port[mesh]}) == 1


@pytest.mark.parametrize("mesh", sorted(WORLDS))
@pytest.mark.parametrize("part", ["row", "col"])
def test_service_over_mesh_matches_reference(runs, mesh, part):
    """The service's coalesced batches and its lone request over the mesh:
    every y within 2e-5 of the reference's, bit-equal across ranks, and
    the batch count, sizes and widths equal the reference's."""
    port, ref, _ = runs
    key = f"svc/{part}"
    for what in ("y", "lone"):
        got = bit_equal(port[mesh], f"{key}/{what}")
        np.testing.assert_allclose(got, ref[f"{mesh}/{key}/{what}"], **TOL)
    for r in port[mesh]:
        np.testing.assert_array_equal(r[f"{key}/batch"],
                                      ref[f"{mesh}/{key}/batch"])
        np.testing.assert_array_equal(r[f"{key}/lone_batch"], [1, 1])
        np.testing.assert_array_equal(r[f"{key}/lone_batch"],
                                      ref[f"{mesh}/{key}/lone_batch"])
        for what in ("batches", "vectors"):
            assert r[f"{key}/{what}"] == int(ref[f"{mesh}/{key}/{what}"])
    assert sorted(set(map(tuple, port[mesh][0][f"{key}/batch"]))) == \
        [(3, 4), (4, 4)]
    # Served one shard a rank: the service's binding is the mesh's.
    for r in port[mesh]:
        assert r[f"{key}/plan"] == (part, AXIS_SIZE[mesh], 1)


@pytest.mark.parametrize("mesh", sorted(WORLDS))
@pytest.mark.parametrize("solve", ["cg", "pr", "pw", "svc_pr", "svc_cg"])
def test_solvers_over_mesh_match_reference(runs, mesh, solve):
    """conjugate_gradient, pagerank and power_iteration with mesh=/axis=,
    and PageRank and CG through the mesh-bound service: the reference's
    iteration counts, x within the solver tests' tolerance, every rank's
    x bit-equal (each rank's stopping test reads the same whole y)."""
    port, ref, _ = runs
    for r in port[mesh]:
        assert r[f"{solve}/iters"] == int(ref[f"{mesh}/{solve}/iters"])
        if f"{solve}/fused" in r:
            assert r[f"{solve}/fused"] is False
            assert not bool(ref[f"{mesh}/{solve}/fused"])
    got = bit_equal(port[mesh], f"{solve}/x")
    np.testing.assert_allclose(got, ref[f"{mesh}/{solve}/x"], **SOLVE_TOL)
    if solve == "pw":
        for r in port[mesh]:
            np.testing.assert_allclose(r["pw/lam"], float(ref[f"{mesh}/pw/lam"]),
                                       **SOLVE_TOL)


@pytest.mark.parametrize("mesh", sorted(WORLDS))
def test_update_refreshes_every_plan_and_drops_mesh_bindings(runs, mesh):
    """update() on an entry with a mesh plan cached beside its primary
    re-splices both (byte-identical to the reference's), the mesh binding
    is rebuilt on the next get and serves the new matrix, and the
    operator handed out before keeps the old one
    (tests/test_update.py)."""
    port, ref, data = runs
    for r in port[mesh]:
        assert len(r["upd/plans"]) == 2
        for spec, arrays in r["upd/plans"].items():
            for name, a in zip(("idx", "val", "seg_ids"), arrays):
                want = ref[f"{mesh}/upd/{spec}/{name}"]
                assert a.dtype == want.dtype and a.tobytes() == want.tobytes()
        assert r["upd/rebound"]
    got = bit_equal(port[mesh], "upd/call")
    np.testing.assert_allclose(got, ref[f"{mesh}/upd/call"], **TOL)
    old = bit_equal(port[mesh], "upd/old_call")
    np.testing.assert_allclose(old, ref[f"{mesh}/reg/row/call"], **TOL)
    assert np.abs(got - old).max() > 1e-3     # the delta shows


@pytest.mark.parametrize("mesh", sorted(WORLDS))
def test_byte_pressure_sheds_mesh_bindings_as_the_reference(runs, mesh):
    """Under one byte budget both packages shed the same bindings at the
    same calls (A's two bindings when B is put, B's when A's mesh binding
    is rebuilt, A's when B's is), with every stat equal to the reference's
    after every step and across ranks; nothing is evicted and no prepared
    sort dropped."""
    port, ref, _ = runs
    want = ref[f"{mesh}/pressure"]
    for r in port[mesh]:
        got = [[s[f] for f in worker.STAT_FIELDS] for s in r["pressure"]]
        np.testing.assert_array_equal(got, want)
    last = dict(zip(worker.STAT_FIELDS, want[-1]))
    assert last["bindings_dropped"] == 3 and last["encodes"] == 3
    assert last["evictions"] == 0 and last["prepared_drops"] == 0
    assert len({r["pressure/device_bytes"] for r in port[mesh]}) == 1


REFUSALS = ["get_partition_without_mesh", "get_mesh_without_axis",
            "svc_mesh_without_axis", "svc_partition_without_mesh", "start",
            "fused"]


@pytest.mark.parametrize("name", REFUSALS)
def test_mesh_serving_refuses(runs, name):
    """Each refusal raised with its message on both ranks: the reference's
    ValueErrors, ``start()`` under a mesh (a pipelined dispatch agreed
    across ranks is ROADMAP #8), and ``fused=True`` on a mesh-bound
    operator with the reference's message."""
    port, _, _ = runs
    for r in port["x2"]:
        assert name in r["refusals"], name


def test_two_equal_meshes_share_one_binding(runs):
    """Two meshes made alike over one world compare and hash equal, so the
    registry's (spec, mesh, axis) key gives both the same binding."""
    port, _, _ = runs
    for r in port["x2"]:
        assert r["mesh_equal"] and r["same_binding"]


def test_deferred_request_dispatches_at_the_first_flush_on_every_rank(runs):
    """A request against a put(blocking=False) entry: under a mesh the
    submit waits for the encode, so the first flush serves it on every
    rank (never deferred), bit-equal across ranks and right."""
    port, _, data = runs
    for r in port["x2"]:
        assert r["deferred/served"] and r["deferred/count"] == 0
    got = bit_equal(port["x2"], "deferred/y")
    dense = np.zeros((600, 800), np.float64)
    np.add.at(dense, (data["rows_b"], data["cols_b"]), data["vals_b"])
    want = 1.5 * dense @ data["x"] + 0.5 * data["y"]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_repartition_reuses_the_prepared_sort_or_decodes(runs):
    """A put entry repartitions from its prepared sort (the stream's
    ``to_coo`` patched to fail is never called); an adopted operator has
    none and decodes its stream once (tests/test_registry.py).  Both serve
    the reference's product."""
    port, ref, _ = runs
    want = ref["x2/reg/row/call"]
    for r in port["x2"]:
        assert r["prepared/encodes"] == 2
        assert r["adopted/decoded"] == 1 and r["adopted/encodes"] == 1
        assert "num_shards=2" in r["adopted/spec"]
    for key in ("prepared/call", "adopted/call"):
        np.testing.assert_allclose(bit_equal(port["x2"], key), want, **TOL)


def test_tuner_feedback_is_agreed_across_ranks(runs):
    """An auto-tuned entry served with retune_every=1 while rank 1's clock
    runs three times as fast: every rank records the slowest rank's
    seconds, so the tuners and the plans end equal; without the agreement
    one dispatch already leaves the tuners apart (the control)."""
    port, _, _ = runs
    ranks = port["x2"]
    for key in ("tuner", "spec", "tune", "plan"):
        assert all(r["auto"][key] == ranks[0]["auto"][key]
                   for r in ranks[1:]), key
    assert ranks[0]["auto_unagreed"]["tuner"] != \
        ranks[1]["auto_unagreed"]["tuner"]


def test_pipeline_parameters_are_the_references_in_order():
    """``SpMVPipeline.__init__``'s parameters, in order, are the
    reference's (``mesh``, ``axis`` and ``partition`` after ``backend``);
    the port adds only the keyword-only ``device``."""
    from repro.serve.pipeline import SpMVPipeline as RefPipeline
    from repro_torch.serve.pipeline import SpMVPipeline

    ref = list(inspect.signature(RefPipeline.__init__).parameters)
    got = list(inspect.signature(SpMVPipeline.__init__).parameters)
    assert got == ref + ["device"]
    assert ref.index("mesh") == ref.index("backend") + 1


def test_mesh_on_another_device_type_is_refused():
    """A mesh over CUDA with a CPU registry is refused by the registry's
    get and by the service, before anything is encoded or bound."""
    from repro_torch.core import format as TF
    from repro_torch.core.registry import MatrixRegistry
    from repro_torch.serve.spmv_service import SpMVService

    class CudaMesh:                     # the attributes the checks read
        mesh_dim_names = ("x",)
        device_type = "cuda"

        def size(self, dim):
            return 2

    data = make_data()
    reg = MatrixRegistry(config=TF.SerpensConfig(**BASE), device="cpu")
    mid = reg.put(data["rows"], data["cols"], data["vals"], (600, 800))
    with pytest.raises(ValueError, match="mesh is over 'cuda' devices"):
        reg.get(mid, mesh=CudaMesh(), axis="x")
    assert reg.stats.encodes == 1
    with pytest.raises(ValueError, match="mesh is over 'cuda' devices"):
        SpMVService(reg, mesh=CudaMesh(), axis="x", device="cpu")
