"""The CUDA kernels on the card, against their plain PyTorch versions.

Marked ``cuda``: every test takes the ``card`` fixture, which skips when
no CUDA device is present.  On a machine with one, run::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_chip.py

Tolerance, elementwise: ``|kernel - plain| <= 1e-5 * (|A| @ |x|) + 1e-6``
— the kernels sum with fp32 atomics, in an order that differs from the
plain ``index_add_`` and from run to run.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import format as TF
from repro_torch.core import partition as TP
from repro_torch.core.registry import MatrixRegistry
from repro_torch.core.spmv import SerpensOperator
from repro_torch.kernels import ops
from repro_torch.kernels import serpens_spmv as ks
from repro_torch.serve.spmv_service import SpMVService

from torch_port_util import random_coo

pytestmark = pytest.mark.cuda

SMALL = dict(segment_width=64, lanes=8, sublanes=4, raw_window=4)
CONFIGS = {
    "paper": TF.PAPER_CONFIG,
    "optimized": TF.OPTIMIZED_CONFIG,
    "small": TF.SerpensConfig(**SMALL),
    "tpc2": TF.SerpensConfig(segment_width=128, lanes=16, sublanes=8,
                             tiles_per_chunk=2),
    "raw2-bf16": TF.SerpensConfig(**dict(SMALL, raw_window=2),
                                  value_dtype="bfloat16"),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def assert_close(got, want, scale):
    assert got.shape == want.shape and got.is_cuda
    assert bool(torch.isfinite(got).all())
    bad = (got - want).abs() > 1e-5 * scale + 1e-6
    assert not bool(bad.any()), int(bad.sum())


def card_stream(name, dev, m=3000, k=20000, nnz=40000, seed=0):
    cfg = CONFIGS[name]
    r, c, v = random_coo(m, k, nnz, seed=seed, hot_rows=5)
    plan = TP.make_plan(r, c, v, (m, k), cfg, TP.PlanSpec())
    idx, val, seg = ops.device_arrays(plan.shards[0], dev)
    geo = dict(num_rows_padded=plan.out_rows_padded,
               segment_width=cfg.segment_width)
    kp = plan.num_segments_local * cfg.segment_width
    return idx, val, seg, geo, kp, cfg.tiles_per_chunk


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_spmv_kernel_matches_plain(card, name):
    idx, val, seg, geo, kp, tpc = card_stream(name, card)
    x = torch.randn(kp, device=card)
    before = ks.spmv_launches
    got = ks.spmv(idx, val, seg, x, tiles_per_chunk=tpc, **geo)
    torch.cuda.synchronize()
    assert ks.spmv_launches == before + 1
    assert_close(got, ks.spmv_plain(idx, val, seg, x, **geo),
                 ks.spmv_plain(idx, val.abs(), seg, x.abs(), **geo))


@pytest.mark.parametrize("n", [1, 3, 16])
@pytest.mark.parametrize("name", ["paper", "tpc2", "raw2-bf16"])
def test_spmm_kernel_matches_plain(card, name, n):
    idx, val, seg, geo, kp, tpc = card_stream(name, card)
    x = torch.randn(kp, n, device=card)
    before = ks.spmm_launches
    got = ks.spmm(idx, val, seg, x, tiles_per_chunk=tpc, **geo)
    torch.cuda.synchronize()
    assert ks.spmm_launches == before + 1
    assert_close(got, ks.spmm_plain(idx, val, seg, x, **geo),
                 ks.spmm_plain(idx, val.abs(), seg, x.abs(), **geo))


def test_row_0xffff_on_the_card(card):
    cfg = TF.SerpensConfig(**SMALL)
    m = cfg.lanes * 0x10000
    r = np.array([m - 1, 3], np.int64)
    c = np.array([5, 60], np.int64)
    v = np.array([2.0, -1.0], np.float32)
    sm = TF.encode(r, c, v, (m, 64), cfg)
    idx, val, seg = ops.device_arrays(sm, card)
    x = torch.arange(64, dtype=torch.float32, device=card)
    got = ks.spmv(idx, val, seg, x, num_rows_padded=sm.padded_rows,
                  segment_width=64)
    assert float(got[m - 1]) == 10.0 and float(got[3]) == -60.0
    assert float(got.abs().sum()) == 70.0


def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    idx, val, seg, geo, kp, _ = card_stream("small", card)
    x = torch.randn(kp, 2, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        ks.spmm(idx, val, seg, x.t().contiguous().t(), **geo)
    with pytest.raises(ValueError, match="float32"):
        ks.spmv(idx, val, seg, x[:, 0].double().contiguous(), **geo)
    with pytest.raises(ValueError, match="share one device"):
        ks.spmv(idx, val, seg, x[:, 0].cpu().contiguous(), **geo)
    with pytest.raises(ValueError, match="multiple of segment_width"):
        ks.spmv(idx, val, seg, x[:-1, 0].contiguous(), **geo)
    with pytest.raises(ValueError, match="not a fallback"):
        SerpensOperator(TP.make_plan(*random_coo(30, 40, 90), (30, 40),
                                     CONFIGS["small"], TP.PlanSpec()),
                        device=card, backend="torch")


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["sync", "pipelined"])
def test_service_on_the_card_launches_both_kernels(card, pipelined):
    m, k = 2000, 3000
    r, c, v = random_coo(m, k, 30000, seed=3, hot_rows=4)
    reg = MatrixRegistry(config=TF.OPTIMIZED_CONFIG, device=card)
    mid = reg.put(r, c, v, (m, k))
    with pytest.raises(ValueError, match="registry binds on"):
        SpMVService(reg, device="cpu")
    svc = SpMVService(reg, max_bucket=16, device=card)
    rng = np.random.default_rng(4)
    xs = rng.normal(size=(12, k)).astype(np.float32)
    dense = np.zeros((m, k), np.float64)
    np.add.at(dense, (r, c), v.astype(np.float64))
    before = (ks.spmv_launches, ks.spmm_launches)
    if pipelined:
        # The rest are queued before the stage threads start, so they
        # coalesce into SpMM batches whatever the timing.
        t0 = svc.submit(mid, xs[0], alpha=2.0)
        with svc:
            lone = svc.result(t0, timeout=120)
        tickets = [svc.submit(mid, x) for x in xs[1:]]
        with svc:
            res = [svc.result(t, timeout=120) for t in tickets]
    else:
        t0 = svc.submit(mid, xs[0], alpha=2.0)
        lone = svc.flush()[t0]
        tickets = [svc.submit(mid, x) for x in xs[1:]]
        out = svc.flush()
        res = [out[t] for t in tickets]
    assert (lone.batch_size, lone.bucket_n) == (1, 1)
    assert ks.spmv_launches > before[0] and ks.spmm_launches > before[1]
    np.testing.assert_allclose(lone.y, 2.0 * dense @ xs[0], rtol=1e-4,
                               atol=1e-4)
    for x, got in zip(xs[1:], res):
        np.testing.assert_allclose(got.y, dense @ x, rtol=1e-4, atol=1e-4)
    reg.close()
