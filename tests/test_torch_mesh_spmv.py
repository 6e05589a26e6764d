"""The port's mesh path against the reference's ``shard_map`` path.

The reference runs in a subprocess with four host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
``tests/test_distributed.py`` runs it), one for each mesh, all at once:
``ShardedSerpensSpMV``, ``SerpensOperator(plan, mesh=, axis=)`` and
``with_mesh`` over a 2- and a 4-device ``x`` axis and the ``model`` axis
of a ``(2, 2)`` ``("data", "model")`` mesh.  The port runs the same
cases in one ``gloo`` world of fresh processes for each mesh
(``repro_torch.launch.mesh.run_world``, a ``file://`` store under the
test's temporary directory, so worlds that run side by side cannot
collide), every rank holding one shard.  Every
rank's y is held to the reference's within rtol = atol = 2e-5 (the
reference's own tolerance, ``tests/test_distributed.py``) and to every
other rank's bit for bit.  Each world and the reference run under a
deadline; past it they are killed and the fixture fails.
"""
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
WORLD_TIMEOUT_S = 120.0
REF_TIMEOUT_S = 240.0

BASE = {"segment_width": 128, "lanes": 16, "sublanes": 8}
# name -> operator config, how it is built, and the products it runs
# (torch_mesh_worker.apply).  "spill" is test_distributed's hot-row
# config: raw window 2, the spill side-stream, lane_balance 1.1.
CASES = {
    "matvec": {"config": BASE, "hot": False, "via": "sharded",
               "lane_assign": "modulo", "ops": ["call"]},
    "matmat": {"config": BASE, "hot": False, "via": "sharded",
               "lane_assign": "modulo", "ops": ["mmab"]},
    "spill": {"config": dict(BASE, raw_window=2, spill_hot_rows=True,
                             lane_balance=1.1),
              "hot": True, "via": "sharded", "lane_assign": "modulo",
              "ops": ["call", "mm"]},
    "balanced": {"config": BASE, "hot": False, "via": "operator",
                 "lane_assign": "balanced", "ops": ["call", "mm"]},
    "bf16": {"config": dict(BASE, value_dtype="bfloat16"), "hot": False,
             "via": "sharded", "lane_assign": "modulo",
             "ops": ["call", "mm"]},
    "with_mesh": {"config": BASE, "hot": False, "via": "with_mesh",
                  "lane_assign": "modulo", "ops": ["call"]},
}
WORLDS = {"x2": 2, "x4": 4, "dm2x2": 4}

REFERENCE = r"""
import json, sys
import numpy as np
from repro import compat
from repro.core import format as F
from repro.core import partition as P
from repro.core import spmv as S

inp = dict(np.load(sys.argv[1]))
cases = json.load(open(sys.argv[2]))
mname = sys.argv[4]
shape, names, axis = {"x2": ((2,), ("x",), "x"), "x4": ((4,), ("x",), "x"),
                      "dm2x2": ((2, 2), ("data", "model"), "model")}[mname]
mesh = compat.make_mesh(shape, names)
n = mesh.shape[axis]
out = {}
for part in ("row", "col"):
    for name, case in cases.items():
        cfg = F.SerpensConfig(**case["config"])
        rows = inp["rows_hot"] if case["hot"] else inp["rows"]
        args = (rows, inp["cols"], inp["vals"], tuple(inp["shape"]))
        if case["via"] == "sharded":
            op = S.ShardedSerpensSpMV(*args, mesh, axis, part, cfg)
        elif case["via"] == "operator":
            plan = P.make_plan(*args, cfg, P.PlanSpec(
                part, n, case["lane_assign"]))
            op = S.SerpensOperator(plan, mesh=mesh, axis=axis)
        else:
            op = S.SerpensSpMV(*args, cfg).with_mesh(mesh, axis, part)
        key = f"{mname}/{part}/{name}"
        for what in case["ops"]:
            if what == "mv":
                got = op.matvec(inp["x"])
            elif what == "call":
                got = op(inp["x"], 1.5, 0.5, inp["y"])
            elif what == "mm":
                got = op.matmat(inp["xm"])
            else:
                got = op.matmat(inp["xm"], -0.5, 2.0, inp["ym"])
            out[f"{key}/{what}"] = np.asarray(got)
        out[f"{key}/device_bytes"] = op.device_bytes
        # What the reference's binding holds: the stacked (padded)
        # shards, the Pallas kernel's per-chunk segment ids, the aux
        # triples and row_perm.
        out[f"{key}/stacked_bytes"] = sum(int(a.nbytes) for a in (
            op._idx, op._val, op._seg, *op._aux))
        out[f"{key}/seg_chunk_bytes"] = int(op._seg_chunk.nbytes)
        out[f"{key}/shard_bytes"] = sum(
            int(sm.idx.nbytes + sm.val.nbytes + sm.seg_ids.nbytes)
            + (int(sm.aux_rows.nbytes + sm.aux_cols.nbytes
                   + sm.aux_vals.nbytes) if sm.n_aux else 0)
            for sm in op.plan.shards)
        out[f"{key}/row_perm_bytes"] = (
            0 if op._row_perm is None else int(op._row_perm.nbytes))
np.savez(sys.argv[3], **out)
"""


def make_data():
    rows, cols, vals = TM.uniform_random(600, 800, 5000, seed=1)
    rows_hot = rows.copy()
    rows_hot[: len(rows_hot) // 3] = 0      # hot row 0: the spill engages
    rng = np.random.default_rng(0)
    return {"rows": rows, "rows_hot": rows_hot, "cols": cols, "vals": vals,
            "shape": np.array([600, 800]),
            "x": rng.normal(size=800).astype(np.float32),
            "y": rng.normal(size=600).astype(np.float32),
            "xm": rng.normal(size=(800, 4)).astype(np.float32),
            "ym": rng.normal(size=(600, 4)).astype(np.float32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each world's per-rank results, the reference's outputs).  The
    reference's subprocesses run while the port's worlds do."""
    d = tmp_path_factory.mktemp("mesh")
    data = make_data()
    np.savez(d / "inputs.npz", **data)
    (d / "cases.json").write_text(json.dumps(CASES))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    refs = {name: subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(d / "inputs.npz"),
         str(d / "cases.json"), str(d / f"ref_{name}.npz"), name],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name in WORLDS}
    deadline = time.monotonic() + REF_TIMEOUT_S
    try:
        port = {}
        for name, world in WORLDS.items():
            wd = d / name
            wd.mkdir()
            port[name] = tmesh.run_world(
                "torch_mesh_worker:run_cases", world,
                (name, CASES, data, name == "x2"), workdir=str(wd),
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
    return port, reference


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mesh", sorted(WORLDS))
@pytest.mark.parametrize("part", ["row", "col"])
def test_mesh_operator_matches_reference_shard_map(runs, part, mesh, case):
    port, ref = runs
    ranks = port[mesh]
    key = f"{part}/{case}"
    axis_size = worker.MESHES[mesh][0][-1]
    for r in ranks:
        assert r[f"{key}/num_shards"] == axis_size
        assert r[f"{key}/partition"] == part
        assert r[f"{key}/held_shards"] == 1       # its own shard only
    if case == "spill":
        assert ranks[0][f"{key}/n_aux"] > 0, "the spill must engage"
    assert ranks[0][f"{key}/row_perm"] == (case == "balanced")
    for what in CASES[case]["ops"]:
        want = ref[f"{mesh}/{key}/{what}"]
        first = ranks[0][f"{key}/{what}"]
        assert first.shape == want.shape
        np.testing.assert_allclose(first, want, **TOL)
        for r in ranks[1:]:      # every rank ends with the same y
            assert r[f"{key}/{what}"].tobytes() == first.tobytes(), what


@pytest.mark.parametrize("case", ["spill", "balanced", "bf16"])
@pytest.mark.parametrize("mesh", sorted(WORLDS))
@pytest.mark.parametrize("part", ["row", "col"])
def test_device_bytes_keep_the_reference_meaning(runs, part, mesh, case):
    """Every shard of the plan plus row_perm, the same on every rank and
    the same as the one-process operator's on that plan: the bytes of the
    reference plan's shards plus an int64 row_perm.  The reference's
    binding holds more: its shards stacked to one padded shape, the
    Pallas kernel's per-chunk segment ids, and row_perm (int32)."""
    port, ref = runs
    key = f"{part}/{case}"
    r0 = port[mesh][0]
    assert {r[f"{key}/device_bytes"] for r in port[mesh]} == \
        {r0[f"{key}/one_process_bytes"]}
    ref_key = f"{mesh}/{key}"
    shards = int(ref[f"{ref_key}/shard_bytes"])
    stacked = int(ref[f"{ref_key}/stacked_bytes"])
    perm = int(ref[f"{ref_key}/row_perm_bytes"])
    assert (perm > 0) == (case == "balanced")
    assert r0[f"{key}/device_bytes"] == shards + 2 * perm
    assert int(ref[f"{ref_key}/device_bytes"]) == \
        stacked + int(ref[f"{ref_key}/seg_chunk_bytes"]) + perm
    assert stacked >= shards


def test_mesh_coordinates_and_data_parallel_axes(runs):
    port, _ = runs
    assert [r["coord"] for r in port["x2"]] == [0, 1]
    assert [r["coord"] for r in port["x4"]] == [0, 1, 2, 3]
    # (data, model) row-major over ranks: the model coordinate is r % 2.
    assert [r["coord"] for r in port["dm2x2"]] == [0, 1, 0, 1]
    assert {r["dp_axes"] for r in port["dm2x2"]} == {("data",)}


REFUSALS = ["mesh_without_axis", "axis_without_mesh", "axis_size",
            "unknown_axis", "with_mesh_without_axis", "partition",
            "matvec_fused"]


@pytest.mark.parametrize("name", REFUSALS)
def test_mesh_path_refuses(runs, name):
    """Each refusal raised ValueError with its message on both ranks."""
    port, _ = runs
    for r in port["x2"]:
        assert name in r["refusals"], name


def test_mesh_operator_does_not_fuse_and_no_mesh_is_a_no_op(runs):
    port, _ = runs
    for r in port["x2"]:
        assert r["refusals"]["supports_fused_epilogue"] is False
        assert r["refusals"]["with_mesh_none_is_self"] is True


def test_mesh_on_other_devices_is_refused():
    """A mesh over one device type and an operator on another raise: the
    mesh path never carries on with tensors off the mesh's devices."""
    from repro_torch.core import format as TF
    from repro_torch.core import partition as TP
    from repro_torch.core import spmv as tspmv

    class CudaMesh:                     # the attributes the check reads
        mesh_dim_names = ("x",)
        device_type = "cuda"

        def size(self, dim):
            return 2

    data = make_data()
    plan = TP.make_plan(data["rows"], data["cols"], data["vals"], (600, 800),
                        TF.SerpensConfig(**BASE), TP.PlanSpec("row", 2))
    with pytest.raises(ValueError, match="mesh is over 'cuda' devices"):
        tspmv.SerpensOperator(plan, device="cpu", mesh=CudaMesh(), axis="x")


def test_operator_on_another_card_than_its_rank_is_refused(monkeypatch):
    """A rank whose card is cuda:0 cannot build a mesh operator on cuda:1:
    refused before anything is uploaded (no card is touched here)."""
    import torch

    from repro_torch.core import format as TF
    from repro_torch.core import partition as TP
    from repro_torch.core import spmv as tspmv

    class CudaMesh:                     # the attributes the checks read
        mesh_dim_names = ("x",)
        device_type = "cuda"

        def size(self, dim):
            return 2

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    data = make_data()
    plan = TP.make_plan(data["rows"], data["cols"], data["vals"], (600, 800),
                        TF.SerpensConfig(**BASE), TP.PlanSpec("col", 2))
    with pytest.raises(ValueError, match="this rank's device is cuda:0; "
                                         "this operator runs on cuda:1"):
        tspmv.SerpensOperator(plan, device="cuda:1", mesh=CudaMesh(),
                              axis="x")


def test_mesh_constructors_name_the_reference_axes(monkeypatch):
    made = []
    monkeypatch.setattr(tmesh, "init_device_mesh",
                        lambda dev, shape, mesh_dim_names: made.append(
                            (dev, shape, mesh_dim_names)))
    tmesh.make_production_mesh()
    tmesh.make_production_mesh(multi_pod=True)
    tmesh.make_host_mesh(2, 2)
    assert made == [("cuda", (16, 16), ("data", "model")),
                    ("cuda", (2, 16, 16), ("pod", "data", "model")),
                    ("cpu", (2, 2), ("data", "model"))]

    class Named:
        def __init__(self, names):
            self.mesh_dim_names = names

    assert tmesh.dp_axes(Named(("pod", "data", "model"))) == ("pod", "data")
    assert tmesh.dp_axes(Named(("data", "model"))) == ("data",)


def test_run_world_kills_a_world_past_its_deadline(tmp_path):
    t = time.monotonic()
    with pytest.raises(TimeoutError, match=r"ranks \[0, 1\]"):
        tmesh.run_world("torch_mesh_worker:wait_forever", 2,
                        workdir=str(tmp_path), timeout_s=20.0)
    assert time.monotonic() - t < 60


def test_run_world_kills_the_others_when_a_rank_fails(tmp_path):
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="ranks failed"):
        tmesh.run_world("torch_mesh_worker:fail_on_rank_1", 2,
                        workdir=str(tmp_path), timeout_s=60.0)
    assert time.monotonic() - t < 40
