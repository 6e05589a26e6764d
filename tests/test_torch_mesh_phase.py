"""``chip_smoke.py`` phases 15 and 16 on the CPU: each phase's setup and
rank function in a 2-rank ``gloo`` world, at small matrices.

The card runs the same code at the G7 stand-in's full size; here the
ranks' tensors lie on the CPU, so the kernel wrappers run their plain
versions.  Phase 15's ranks hold their shard's mesh matvec and matmat to
the one-process operator and to fp64; phase 16's serve requests and
solve through the registry, the service and the solvers over the mesh,
held to fp64 and to the one-process operator and solvers.  Each holds
its results to rank 0's bit for bit, and the product without the
combine (the control) must fail, or the rank raises and the world fails.
"""
import os
import sys

import pytest
import torch

from repro_torch.data.matrices import paper_matrix
from repro_torch.launch import mesh as tmesh

sys.path.append(os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def phase(tmp_path_factory):
    rows, cols, vals, shape, _ = paper_matrix("G7", scale=0.02, seed=0)
    workdir = str(tmp_path_factory.mktemp("phase15"))
    info = chip_smoke.mesh_setup(rows, cols, vals, shape,
                                 torch.device("cpu"), workdir)
    ranks = tmesh.run_world("chip_smoke:mesh_rank", chip_smoke.MESH_RANKS,
                            (workdir, "cpu"), workdir=workdir,
                            timeout_s=120.0)
    return info, ranks, workdir


@pytest.mark.parametrize("part", chip_smoke.MESH_PARTS)
def test_phase15_ranks_agree_and_the_control_fails(phase, part):
    info, ranks, _ = phase
    assert [r["parts"][part]["coord"] for r in ranks] == [0, 1]
    for r in ranks:
        rec = r["parts"][part]
        assert "elements out of tolerance" in rec["control"]
        for what in ("matvec", "matmat"):
            assert rec[f"{what}_vs_fp64"] < 1e-3
            assert rec[f"{what}_vs_one"] < 1e-3
        # CPU tensors: the wrappers ran their plain versions, which count
        # no launch (on the card the phase requires both kernels).
        assert set(rec["launches"].values()) == {0}
        assert rec["device_bytes"] == info[part]["device_bytes"]
        assert rec["shard_stream_bytes"] == \
            info[part]["shard_stream_bytes"][rec["coord"]]
        assert min(rec["shard_ms"], rec["combine_ms"], rec["matvec_ms"]) > 0



@pytest.fixture(scope="module")
def serve_phase(tmp_path_factory):
    """Phase 16's inputs and references, its rank function in a 2-rank
    CPU world and the host's checks, at G7 and G5 scale 0.02."""
    from repro_torch.data.matrices import column_normalize

    rows, cols, vals, shape, _ = paper_matrix("G7", scale=0.02, seed=0)
    gv = column_normalize(rows, cols, vals, shape[0])
    r5, c5, v5, shape5, _ = paper_matrix("G5", scale=0.02, seed=0)
    g5 = (*chip_smoke.spd_from_upper(r5, c5, v5, shape5[0]), shape5, 0.02)
    workdir = str(tmp_path_factory.mktemp("phase16"))
    chip_smoke.mesh_serve_inputs(rows, cols, gv, shape, g5, workdir)
    info = chip_smoke.mesh_serve_references(rows, cols, gv, shape, g5,
                                            workdir)
    ranks = tmesh.run_world("chip_smoke:mesh_serve_rank",
                            chip_smoke.MESH_RANKS, (workdir, "cpu"),
                            workdir=workdir, timeout_s=240.0)
    return ranks, chip_smoke.mesh_serve_check(info, ranks)


def test_phase16_ranks_agree_and_the_control_fails(serve_phase):
    """Every rank repartitions once on get (encodes 1 → 2, the second get
    cached, col a third encode; G5's registry a put and a repartition),
    serves
    the flush as two 16-wide batches and the lone request alone, stops
    each solve at the one-process unfused solver's iteration, agrees with
    fp64 and the one-process operator, and fails without the combine."""
    ranks, host = serve_phase
    assert [r["coord"] for r in ranks] == [0, 1]
    for r in ranks:
        assert r["encodes"] == [1, 2, 2, 3]
        assert r["encodes_g5"] == [1, 2]
        assert "elements out of tolerance" in r["control"]
        assert r["iters"] == r["iters_one"] == ranks[0]["iters"]
        assert min(r["iters"].values()) > 1
        for what in ("vs_fp64", "vs_one", "col_vs_fp64", "pagerank_vs_one",
                     "cg_vs_one"):
            assert r[what] < 1e-3, what
        # CPU tensors: the wrappers ran their plain versions, which count
        # no launch (on the card the phase requires spmm in the flush and
        # spmv in the lone request and the solves).
        for part in ("flush", "lone", "solve"):
            assert set(r["launches"][part].values()) == {0}
        stats = r["svc_stats"]
        # A warm-up batch and solve, the flush's two batches, the lone
        # request, the solve.
        assert stats["batches"] == 2 + 2 + 1 + 1
        assert stats["deferred"] == 0
        assert r["reg_stats"]["bindings_dropped"] == 0
        assert r["reg_stats"]["evictions"] == 0
    assert host["pagerank_vs_fp64"] < 1e-3
    assert host["cg_true_residual"] <= 1e-4
