"""``chip_smoke.py`` phase 15 on the CPU: its setup and its rank function
in a 2-rank ``gloo`` world, at a small matrix.

The card runs the same code at the G7 stand-in's full size; here the
ranks' tensors lie on the CPU, so the kernel wrappers run their plain
versions.  Each rank holds its shard's mesh matvec and matmat to the
one-process operator and to fp64, and to rank 0's bit for bit, and the
product without the combine (the control) must fail that check, or the
rank raises and the world fails.
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

