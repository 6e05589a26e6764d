"""The port's registry and SpMV service against the JAX reference's.

The same seeded matrix and the same 3-owner request mix (mixed alpha/beta,
a lone request, a batch that pads to a power-of-two bucket) go through
``repro.serve.spmv_service.SpMVService`` and the port's, synchronously and
pipelined.  Both must return equal ``y`` within rtol = atol = 1e-5 (fp32
scatter-adds sum in another order) and form the same batches.
"""
import numpy as np
import pytest
import torch

from repro.core import format as F
from repro.core import registry as JR
from repro.serve import spmv_service as JS
from repro_torch.core import format as TF
from repro_torch.core import registry as TR
from repro_torch.serve import spmv_service as TS

from torch_port_util import random_coo

TOL = dict(rtol=1e-5, atol=1e-5)   # fp32 sums in another order
SMALL = dict(segment_width=64, lanes=8, sublanes=4, raw_window=4)
OWNERS = ("alice", "bob", "carol")
M, K = 120, 200


def registries(**cfg_kw):
    cfg = dict(SMALL, **cfg_kw)
    return (JR.MatrixRegistry(config=F.SerpensConfig(**cfg)),
            TR.MatrixRegistry(config=TF.SerpensConfig(**cfg), device="cpu"))


def requests(n=22, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        x = rng.normal(size=K).astype(np.float32)
        alpha = float(rng.uniform(-2, 2))
        if i % 3 == 0:
            beta, y = 0.0, None
        else:
            beta, y = float(rng.uniform(-1, 1)), \
                rng.normal(size=M).astype(np.float32)
        out.append((x, alpha, beta, y, OWNERS[i % 3]))
    return out


def serve(svc, mid, reqs, pipelined):
    """Lone request first, then the rest in one go.  Pipelined, the rest
    are queued before the stage threads start, so the dispatcher coalesces
    them exactly as one synchronous flush does."""
    def submit(r):
        x, a, b, y, o = r
        return svc.submit(mid, x, alpha=a, beta=b, y=y, owner=o)

    if not pipelined:
        t0 = submit(reqs[0])
        first = svc.flush()[t0]
        tickets = [submit(r) for r in reqs[1:]]
        out = svc.flush()
        return [first] + [out[t] for t in tickets]
    t0 = submit(reqs[0])
    with svc:
        first = svc.result(t0, timeout=60)
    tickets = [submit(r) for r in reqs[1:]]
    with svc:
        rest = [svc.result(t, timeout=60) for t in tickets]
    return [first] + rest


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["sync", "pipelined"])
@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
def test_service_matches_reference(pipelined, value_dtype):
    jreg, treg = registries(value_dtype=value_dtype)
    r, c, v = random_coo(M, K, 1500, seed=0, hot_rows=3)
    jmid = jreg.put(r, c, v, (M, K))
    tmid = treg.put(r, c, v, (M, K))
    assert jmid == tmid                     # same content key
    reqs = requests()
    jsvc, tsvc = JS.SpMVService(jreg, max_bucket=8), \
        TS.SpMVService(treg, max_bucket=8, device="cpu")
    jres = serve(jsvc, jmid, reqs, pipelined)
    tres = serve(tsvc, tmid, reqs, pipelined)
    shapes = [(t.batch_size, t.bucket_n) for t in tres]
    assert shapes == [(j.batch_size, j.bucket_n) for j in jres]
    assert shapes == [(1, 1)] + [(8, 8)] * 16 + [(5, 8)] * 5
    dense = treg.get(tmid).to_dense().astype(np.float64)
    for req, j, t in zip(reqs, jres, tres):
        assert t.error is None and t.owner == req[4]
        assert t.y.dtype == np.float32 and t.y.shape == (M,)
        np.testing.assert_allclose(t.y, j.y, **TOL)
        x, a, b, y, _ = req
        want = a * (dense @ x) + (0.0 if y is None else b * y)
        np.testing.assert_allclose(t.y, want, rtol=1e-4, atol=1e-4)
    js, ts = jsvc.stats, tsvc.stats
    assert (ts.batches, ts.vectors, ts.stream_bytes) == \
        (js.batches, js.vectors, js.stream_bytes)


def test_serve_helper_and_owner_queues():
    jreg, treg = registries()
    r, c, v = random_coo(M, K, 900, seed=2)
    mid = treg.put(r, c, v, (M, K))
    jmid = jreg.put(r, c, v, (M, K))
    xs = np.random.default_rng(3).normal(size=(5, K)).astype(np.float32)
    got = TS.SpMVService(treg, device="cpu").serve([(mid, x, 0.5) for x in xs])
    want = JS.SpMVService(jreg).serve([(jmid, x, 0.5) for x in xs])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)


def test_registry_update_matches_reference():
    jreg, treg = registries()
    r, c, v = random_coo(M, K, 1200, seed=4)
    mid = treg.put(r, c, v, (M, K), partition="row", num_shards=2)
    jmid = jreg.put(r, c, v, (M, K), partition="row", num_shards=2)
    dr, dc, dv = random_coo(M, K, 40, seed=5)
    x = np.random.default_rng(6).normal(size=K).astype(np.float32)
    for mode in ("add", "set", "delete"):
        treg.update(mid, dr, dc, dv, mode=mode)
        jreg.update(jmid, dr, dc, dv, mode=mode)
        top, jop = treg.get(mid), jreg.get(jmid)
        assert top.plan.idx.tobytes() == jop.plan.idx.tobytes()
        np.testing.assert_allclose(top.matvec(x).numpy(),
                                   np.asarray(jop.matvec(x)), **TOL)
    assert treg.version(mid) == jreg.version(jmid) == 3


def test_background_put_serves_when_ready():
    _, treg = registries()
    r, c, v = random_coo(M, K, 800, seed=7)
    mid = treg.put(r, c, v, (M, K), blocking=False)
    svc = TS.SpMVService(treg, device="cpu")
    x = np.ones(K, np.float32)
    (y,) = svc.serve([(mid, x)], timeout=60)
    assert treg.ready(mid)
    np.testing.assert_allclose(y, treg.get(mid).to_dense() @ x, **TOL)
    treg.close()


def _budget(reg_cls, **kw):
    """Room for two streams and one binding, not for a third entry."""
    probe = reg_cls(**kw)
    r, c, v = random_coo(40, 60, 300, seed=8)
    stream = probe.get(probe.put(r, c, v, (40, 60))).stream_bytes
    return 2 * stream + probe.device_bytes_in_use + stream // 2


def test_byte_budget_evicts_like_reference():
    jcfg, tcfg = F.SerpensConfig(**SMALL), TF.SerpensConfig(**SMALL)
    jreg = JR.MatrixRegistry(
        byte_budget=_budget(JR.MatrixRegistry, config=jcfg), config=jcfg)
    treg = TR.MatrixRegistry(
        byte_budget=_budget(TR.MatrixRegistry, config=tcfg, device="cpu"),
        config=tcfg, device="cpu")
    mids = []
    for seed in (8, 9, 10):
        r, c, v = random_coo(40, 60, 300, seed=seed)
        mids.append(treg.put(r, c, v, (40, 60)))
        assert jreg.put(r, c, v, (40, 60)) == mids[-1]
    assert [m in treg for m in mids] == [m in jreg for m in mids] \
        == [False, True, True]
    ts, js = treg.stats_snapshot(), jreg.stats_snapshot()
    assert (ts.evictions, ts.bindings_dropped, ts.prepared_drops) == \
        (js.evictions, js.bindings_dropped, js.prepared_drops)
    assert treg.bytes_in_use <= treg.byte_budget


def test_later_slices_raise_not_implemented():
    _, treg = registries()
    r, c, v = random_coo(M, K, 300, seed=11)
    with pytest.raises(NotImplementedError, match="auto-tuner"):
        treg.put(r, c, v, (M, K), spec="auto")
    with pytest.raises(NotImplementedError, match="analysis"):
        treg.put(r, c, v, (M, K), verify="fast")
    with pytest.raises(NotImplementedError, match="analysis"):
        TR.MatrixRegistry(device="cpu", verify="full")
    with pytest.raises(ValueError, match="verify must be"):
        treg.put(r, c, v, (M, K), verify="maybe")
    mid = treg.put(r, c, v, (M, K))
    assert treg.record_observation(mid, slots_per_s=1.0) is False
    svc = TS.SpMVService(treg, device="cpu")
    with pytest.raises(NotImplementedError, match="solver slice"):
        svc.submit_solve(mid, "pagerank")
    with pytest.raises(NotImplementedError, match="solver slice"):
        svc.solve(mid, "cg", b=np.ones(M, np.float32))


def test_entry_points_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.MatrixRegistry()
    with pytest.raises(ValueError, match="JAX backend"):
        TR.MatrixRegistry(device="cpu", backend="pallas")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        TS.SpMVService(TR.MatrixRegistry(device="cpu"), backend="cuda",
                      device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.SpMVService(TR.MatrixRegistry(device="cpu"))
