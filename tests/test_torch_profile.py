"""The port's cost reports (``repro_torch.obs.profile``) against the
reference's (``repro.obs.profile``), on the CPU.

The modeled fields come from the plan's host arrays, and the two encoders
give byte-identical plans, so at an equal bandwidth both reports must be
equal key for key, with no tolerance.  The measured path is checked on a
CPU operator (host clock) for its arithmetic only; its card path (CUDA
events) is in ``tests/test_torch_chip.py``.
"""
import json
import os

import numpy as np
import pytest

from repro.core import format as JF
from repro.core import partition as JP
from repro.core.spmv import SerpensOperator as JOperator
from repro.obs import profile as jprofile
from repro_torch.core import format as TF
from repro_torch.core import partition as TP
from repro_torch.core.spmv import SerpensOperator
from repro_torch.data import matrices as M
from repro_torch.obs import profile as tprofile

SMALL = dict(segment_width=128, lanes=8, sublanes=4, raw_window=2)
SPILL = dict(SMALL, spill_hot_rows=True, lane_balance=1.1)
PLANS = {
    "fp32 single": (SMALL, "float32", ("single", 1)),
    "bf16 single": (SPILL, "bfloat16", ("single", 1)),
    "balanced": (SMALL, "float32", ("single", 1, "balanced")),
    "row:2 spill": (SPILL, "float32", ("row", 2)),
    "col:2 bf16": (SMALL, "bfloat16", ("col", 2)),
    "row:3 balanced": (SPILL, "float32", ("row", 3, "balanced")),
}


def operators(name):
    fields, dtype, spec = PLANS[name]
    rows, cols, vals = M.power_law_graph(400, 5000, seed=4)
    jp = JP.make_plan(rows, cols, vals, (400, 400),
                      JF.SerpensConfig(**fields, value_dtype=dtype),
                      JP.PlanSpec(*spec))
    tp = TP.make_plan(rows, cols, vals, (400, 400),
                      TF.SerpensConfig(**fields, value_dtype=dtype),
                      TP.PlanSpec(*spec))
    return JOperator(jp), SerpensOperator(tp, device="cpu")


@pytest.mark.parametrize("bandwidth", [206.0, 3350.0, 1000.0])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_modeled_report_equals_the_reference(name, bandwidth):
    jop, top = operators(name)
    want = jprofile.plan_cost_report(jop, bandwidth_gbps=bandwidth)
    got = top.cost_report(bandwidth_gbps=bandwidth)
    assert list(got) == list(want)
    assert got == want
    assert [list(s) for s in got["shards"]] == \
        [list(s) for s in want["shards"]]


def test_default_bandwidth_is_the_h100s():
    """The port's roofline is the H100 SXM's HBM3 (3.35 TB/s), not the
    paper FPGA's 206 GB/s."""
    _, top = operators("fp32 single")
    rep = top.cost_report()
    assert tprofile.ASSUMED_BANDWIDTH_GBPS == 3350.0
    assert rep["assumed_bandwidth_gbps"] == 3350.0
    assert rep["est_stream_s"] == rep["stream_bytes"] / 3.35e12
    assert "measured_matvec_s" not in rep


@pytest.mark.parametrize("name", ["fp32 single", "row:2 spill"])
def test_measured_report_on_a_cpu_operator(name):
    _, top = operators(name)
    rep = top.cost_report(measure=True, iters=5, bandwidth_gbps=100.0)
    t = rep["measured_matvec_s"]
    assert t > 0
    assert rep["achieved_gbps"] == rep["stream_bytes"] / t / 1e9
    assert rep["roofline_fraction"] == rep["achieved_gbps"] / 100.0
    # Attributed by each shard's own stream bytes (the plan's total also
    # counts the stacked padding of the shorter shards).
    for s in rep["shards"]:
        assert s["measured_s_attributed"] == \
            t * (s["stream_bytes"] / rep["stream_bytes"])
    assert sum(s["measured_s_attributed"] for s in rep["shards"]) <= t
    modeled = top.cost_report(bandwidth_gbps=100.0)
    measured = ("measured_matvec_s", "achieved_gbps", "roofline_fraction")
    assert {k: v for k, v in rep.items() if k not in measured + ("shards",)} \
        == {k: v for k, v in modeled.items() if k != "shards"}
    assert [{k: v for k, v in s.items() if k != "measured_s_attributed"}
            for s in rep["shards"]] == modeled["shards"]


def test_profiler_trace_without_a_logdir_does_nothing(tmp_path):
    with tprofile.profiler_trace(None) as prof:
        assert prof is None
    with tprofile.profiler_trace("") as prof:
        assert prof is None


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    _, top = operators("fp32 single")
    logdir = tmp_path / "traces"
    x = np.ones(400, np.float32)
    for _ in range(2):
        with tprofile.profiler_trace(str(logdir)) as prof:
            top.matvec(x)
    names = sorted(os.listdir(logdir))
    assert len(names) == 2 and all(n.startswith("trace_") for n in names)
    with open(logdir / names[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("index_add" in e.get("name", "") for e in events)
    assert any("index_add" in e.key for e in prof.key_averages())
