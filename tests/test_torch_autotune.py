"""The port's matrix features, plan tuner and auto-tuned registry and
service, held against the JAX reference's.

The same seeded triples (numpy) go through ``repro.core.{features,
autotune,registry}`` and the port's copies.  Features must be equal
(integers exactly, floats to rtol 1e-12) with equal bucket strings; the
port's candidate lists and tuner decisions are the reference's for its
``"xla"`` backend, with the backend renamed to the port's ``"cuda"`` or
``"torch"``; an auto put picks the same arm and encodes a byte-identical
stream, and its product agrees within rtol = atol = 1e-5 (fp32 sums in
another order).  Everything runs on the CPU (``device="cpu"``).
"""
import dataclasses
import json
import os

import numpy as np
import pytest

from repro import obs as jobs
from repro.core import autotune as JA
from repro.core import features as JF
from repro.core import format as F
from repro.core import registry as JR
from repro.serve import spmv_service as JS
from repro_torch import obs as tobs
from repro_torch.core import autotune as TA
from repro_torch.core import features as TFE
from repro_torch.core import format as TF
from repro_torch.core import registry as TR
from repro_torch.data import matrices as TM
from repro_torch.kernels import ops as kops
from repro_torch.serve import spmv_service as TS

from torch_port_util import assert_same_plan, random_coo

TOL = dict(rtol=1e-5, atol=1e-5)   # fp32 sums in another order
SMALL = dict(segment_width=64, lanes=8, sublanes=4, raw_window=4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INT_FIELDS = ("nnz", "nnz_row_max", "num_segments")
FLOAT_FIELDS = ("density", "nnz_row_mean", "nnz_row_cv", "gini",
                "bandwidth", "segment_locality", "lane_imbalance")


def configs(**kw):
    cfg = dict(SMALL, **kw)
    return F.SerpensConfig(**cfg), TF.SerpensConfig(**cfg)


def assert_same_features(ref, port) -> None:
    assert tuple(ref.shape) == tuple(port.shape)
    for name in INT_FIELDS:
        assert getattr(ref, name) == getattr(port, name), name
    for name in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(port, name), getattr(ref, name),
                                   rtol=1e-12, atol=0.0, err_msg=name)
    assert ref.bucket() == port.bucket()


def renamed(obj, backend: str):
    """A reference JSON-able object with its ``"xla"`` backend renamed."""
    return json.loads(json.dumps(obj).replace('"xla"', f'"{backend}"')
                      .replace("@xla", f"@{backend}"))


def skewed(n=64, nnz=900, seed=6):
    r, c, v = TM.power_law_graph(n, nnz, seed=seed)
    return r, c, v, (n, n)


def banded(n=256):
    r = np.repeat(np.arange(n), 3)
    c = np.clip(r + np.tile([-1, 0, 1], n), 0, n - 1)
    v = np.random.default_rng(n).normal(size=r.size).astype(np.float32)
    return r, c, v, (n, n)


def uniform(m=48, k=64, nnz=500, seed=0):
    r, c, v = random_coo(m, k, nnz, seed=seed)
    return r, c, v, (m, k)


# (name, triples) for the registry cases: a power-law graph (the skewed
# arms: balanced lanes, spill), a band (the column split) and a uniform
# random matrix (the plain arms).
MATRICES = {"skewed": skewed, "banded": banded, "uniform": uniform}


# -- features -----------------------------------------------------------------
@pytest.mark.parametrize("gid", [f"G{i}" for i in range(1, 13)])
def test_features_match_reference_on_paper_stand_ins(gid):
    edges = TM.PAPER_TABLE3[gid][2]
    r, c, v, shape, _ = TM.paper_matrix(gid, scale=min(1.0, 3e4 / edges),
                                        seed=1)
    jcfg, tcfg = F.SerpensConfig(), TF.SerpensConfig()
    ref = JF.compute_features(r, c, shape, jcfg)
    port = TFE.compute_features(r, c, shape, tcfg)
    assert_same_features(ref, port)
    # Through the prepared sort's bucket key, cached on the PreparedCOO.
    prep = TF.prepare(r, c, v, shape, tcfg)
    got = TFE.features_of(prep)
    assert prep.features is got and TFE.features_of(prep) is got
    assert_same_features(JF.features_of(F.prepare(r, c, v, shape, jcfg)),
                         got)
    assert got == port


def test_features_match_reference_on_edge_cases():
    jcfg, tcfg = configs()
    for r, c, shape in (([], [], (8, 8)), ([0], [0], (64, 8)),
                        ([0], [0], (8, 4096)), ([3, 3], [5, 5], (1, 9)),
                        (np.zeros(64, np.int64), np.arange(64), (64, 64))):
        assert_same_features(JF.compute_features(r, c, shape, jcfg),
                             TFE.compute_features(r, c, shape, tcfg))


def test_feature_thresholds_are_the_reference_ones():
    assert TFE.CV_THRESHOLDS == JF.CV_THRESHOLDS
    assert TFE.BANDWIDTH_THRESHOLDS == JF.BANDWIDTH_THRESHOLDS


try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYP = True
except ImportError:
    HAVE_HYP = False

if HAVE_HYP:
    @settings(max_examples=40, deadline=None)
    @given(st.integers(1, 60), st.integers(1, 300), st.integers(0, 400),
           st.sampled_from([(64, 8), (16, 4), (128, 16)]),
           st.integers(0, 10_000))
    def test_property_features_match_reference(m, k, nnz, geo, seed):
        rng = np.random.default_rng(seed)
        r = rng.integers(0, m, nnz)
        c = rng.integers(0, k, nnz)
        v = rng.normal(size=nnz).astype(np.float32)
        w, lanes = geo
        jcfg, tcfg = configs(segment_width=w, lanes=lanes)
        assert_same_features(
            JF.features_of(F.prepare(r, c, v, (m, k), jcfg)),
            TFE.features_of(TF.prepare(r, c, v, (m, k), tcfg)))


# -- candidates ---------------------------------------------------------------
@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("matrix", sorted(MATRICES))
def test_candidates_are_the_reference_xla_list(backend, matrix):
    r, c, _, shape = MATRICES[matrix]()
    jcfg, tcfg = configs()
    want = JA.default_candidates(JF.compute_features(r, c, shape, jcfg),
                                 backend="xla")
    got = TA.default_candidates(TFE.compute_features(r, c, shape, tcfg),
                                backend)
    assert [x.key for x in got] == \
        [x.key.replace("@xla", f"@{backend}") for x in want]
    assert [x.to_dict() for x in got] == \
        [renamed(x.to_dict(), backend) for x in want]
    # Every candidate's config overrides are the reference's.
    for j, t in zip(want, got):
        assert dataclasses.asdict(t.apply_config(tcfg)) == \
            dataclasses.asdict(j.apply_config(jcfg))


@pytest.mark.parametrize("backend", ["xla", "pallas", "auto", None, "cpu"])
def test_candidates_and_tuner_refuse_other_backends(backend):
    f = TFE.compute_features([0, 1], [1, 0], (2, 2), configs()[1])
    with pytest.raises(ValueError, match="backend"):
        TA.default_candidates(f, backend)
    with pytest.raises(ValueError, match="backend"):
        TA.PlanTuner(backend=backend)


def test_tuner_backends_are_the_dispatch_ones():
    assert TA.BACKENDS == kops.BACKENDS


# -- the tuner ----------------------------------------------------------------
def drive(tuner, feats, rng, steps=60):
    """A seeded sequence of choose/observe calls; returns the decisions."""
    out = []
    for _ in range(steps):
        f = feats[int(rng.integers(len(feats)))]
        d = tuner.choose(f, explore=bool(rng.integers(2)))
        out.append(d.to_dict())
        if rng.random() < 0.7:
            rate = float(rng.uniform(1e6, 1e9))
            req = float(rng.uniform(1.0, 1e4)) if rng.random() < 0.8 \
                else None
            tuner.observe(d.bucket, d.candidate, rate, requests_per_s=req,
                          predicted=d.predicted)
    return out


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_tuner_matches_reference(backend, seed):
    jcfg, tcfg = configs()
    mats = [m() for m in MATRICES.values()]
    jf = [JF.compute_features(r, c, s, jcfg) for r, c, _, s in mats]
    tf = [TFE.compute_features(r, c, s, tcfg) for r, c, _, s in mats]
    kw = dict(epsilon=0.3, alpha=0.4, seed=seed)
    jt = JA.PlanTuner(backend="xla", metrics=jobs.MetricsRegistry(), **kw)
    tt = TA.PlanTuner(backend=backend, metrics=tobs.MetricsRegistry(), **kw)
    want = drive(jt, jf, np.random.default_rng(seed))
    got = drive(tt, tf, np.random.default_rng(seed))
    assert got == renamed(want, backend)
    assert tt.to_json() == renamed(jt.to_json(), backend)
    assert tt.snapshot() == renamed(jt.snapshot(), backend)
    # A prior written by the port reloads into the same state.
    again = TA.PlanTuner.from_json(json.loads(json.dumps(tt.to_json())),
                                   backend=backend, alpha=kw["alpha"],
                                   metrics=tobs.MetricsRegistry())
    assert again.to_json() == tt.to_json()


def test_reference_sweep_prior_is_refused():
    """The committed prior was measured for the reference's xla backend,
    off the card: the port never loads it."""
    path = os.path.join(ROOT, "results", "autotune_sweep.json")
    with open(path) as fh:
        assert json.load(fh)["backend"] == "xla"
    for backend in ("cuda", "torch"):
        with pytest.raises(ValueError, match="JAX backend"):
            TA.PlanTuner.load(path, backend=backend)


def test_prior_of_the_other_port_backend_is_refused(tmp_path):
    t = TA.PlanTuner(backend="cuda", metrics=tobs.MetricsRegistry())
    t.observe("bk", TA.TunerCandidate(backend="cuda"), slots_per_s=5.0,
              requests_per_s=2.0)
    path = tmp_path / "prior.json"
    t.save(path)
    assert TA.PlanTuner.load(path, backend="cuda").to_json() == t.to_json()
    wrapped = {"matrices": [], "prior": t.to_json()}
    assert TA.PlanTuner.from_json(wrapped, backend="cuda").to_json() \
        == t.to_json()
    with pytest.raises(ValueError, match="measured on backend 'cuda'"):
        TA.PlanTuner.load(path, backend="torch")


def test_tuner_metrics_use_the_reference_names():
    f = TFE.compute_features(*skewed()[:2], (64, 64), configs()[1])
    t = TA.PlanTuner(backend="torch", epsilon=0.0)
    d = t.choose(f)
    t.observe(d.bucket, d.candidate, slots_per_s=10.0, predicted=20.0)
    t.record_retune(d.bucket)
    snap = tobs.REGISTRY.snapshot()
    for name in ("tuner_decisions_total", "tuner_retunes_total",
                 "tuner_predicted_over_observed_ratio"):
        assert name in snap, name
    ratio = tobs.REGISTRY.get("tuner_predicted_over_observed_ratio")
    assert tuple(ratio.buckets) == JA.RATIO_BUCKETS == TA.RATIO_BUCKETS


# -- the registry -------------------------------------------------------------
def registries(**cfg_kw):
    jcfg, tcfg = configs(**cfg_kw)
    return (JR.MatrixRegistry(config=jcfg, backend="xla"),
            TR.MatrixRegistry(config=tcfg, device="cpu"))


@pytest.mark.parametrize("matrix", sorted(MATRICES))
def test_auto_put_matches_reference(matrix):
    """Same arm, byte-identical stream, same product."""
    r, c, v, shape = MATRICES[matrix]()
    jreg, treg = registries()
    jmid = jreg.put(r, c, v, shape, spec="auto")
    tmid = treg.put(r, c, v, shape, spec="auto")
    assert jmid == tmid                     # same content key
    jd, td = jreg.tune_decision(jmid), treg.tune_decision(tmid)
    assert td.to_dict() == renamed(jd.to_dict(), "torch")
    jop, top = jreg.get(jmid), treg.get(tmid)
    assert_same_plan(jop.plan, top.plan)
    x = np.random.default_rng(3).normal(size=shape[1]).astype(np.float32)
    np.testing.assert_allclose(top.matvec(x).numpy(),
                               np.asarray(jop.matvec(x)), **TOL)
    js, ts = jreg.encode_stats()[jmid], treg.encode_stats()[tmid]
    for key in ("spec", "auto_tuned", "encode_slots"):
        assert js[key] == ts[key], key
    assert ts["tune"] == renamed(js["tune"], "torch")


def test_repeat_auto_put_is_a_hit_and_manual_put_records_no_tune():
    r, c, v, shape = uniform(seed=4)
    _, treg = registries()
    mid = treg.put(r, c, v, shape, spec="auto")
    assert treg.put(r, c, v, shape, spec="auto") == mid
    assert treg.stats.hits == 1 and treg.stats.encodes == 1
    manual = treg.put(r, c, v, shape)
    assert manual != mid
    st = treg.encode_stats()
    assert st[mid]["auto_tuned"] and st[mid]["tune"]["bucket"]
    assert st[manual]["auto_tuned"] is False and st[manual]["tune"] is None
    assert treg.tune_decision(manual) is None
    assert not treg.record_observation(manual, slots_per_s=1.0)
    assert not treg.retune(manual)
    with pytest.raises(TypeError, match="PlanSpec or 'auto'"):
        treg.put(r, c, v, shape, spec="fastest")


def test_background_auto_put_installs_its_decision():
    r, c, v, shape = skewed(seed=7)
    _, treg = registries()
    mid = treg.put(r, c, v, shape, spec="auto", blocking=False)
    op = treg.get(mid, timeout=60)
    assert treg.tune_decision(mid).candidate.spec == op.plan.spec
    assert treg.encode_stats()[mid]["auto_tuned"]
    treg.close()


def test_registry_tuner_follows_its_device():
    _, treg = registries()
    assert treg.get_tuner().backend == "torch"
    assert treg.get_tuner() is treg.tuner
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        TR.MatrixRegistry(device="cpu",
                          tuner=TA.PlanTuner(backend="cuda"))


def test_observation_flips_ranking_and_retune_swaps_plan():
    """Both registries take the same observations: both re-tune onto the
    same arm, with byte-identical streams; the port's old binding's device
    bytes are released."""
    r, c, v, shape = skewed(seed=6)
    jreg, treg = registries()
    jmid = jreg.put(r, c, v, shape, spec="auto")
    tmid = treg.put(r, c, v, shape, spec="auto")
    treg.get(tmid)
    held = treg.device_bytes_in_use
    assert held > 0
    d = treg.tune_decision(tmid)
    chosen = d.candidate.key
    other = next(k for k in d.ranked if k != chosen)
    for reg, tuner_cands, be in (
            (jreg, JA.default_candidates(JF.compute_features(
                r, c, shape, configs()[0]), backend="xla"), "xla"),
            (treg, TA.default_candidates(TFE.compute_features(
                r, c, shape, configs()[1]), "torch"), "torch")):
        for cand in tuner_cands:
            key = cand.key.replace(f"@{be}", "@torch")
            rate = 1e3 if key == chosen else (1e7 if key == other else None)
            for _ in range(4 if rate else 0):
                reg.tuner.observe(d.bucket, cand,
                                  slots_per_s=rate, requests_per_s=rate)
    assert jreg.retune(jmid) is True
    assert treg.retune(tmid) is True
    assert treg.tune_decision(tmid).candidate.key == other
    assert treg.tune_decision(tmid).to_dict() == \
        renamed(jreg.tune_decision(jmid).to_dict(), "torch")
    assert treg.device_bytes_in_use == 0 < held
    assert treg.encode_stats()[tmid]["spec"] == \
        jreg.encode_stats()[jmid]["spec"]
    top = treg.get(tmid)
    assert treg.device_bytes_in_use == top.device_bytes
    assert_same_plan(jreg.get(jmid).plan, top.plan)
    dense = np.zeros(shape, np.float64)
    np.add.at(dense, (r, c), v.astype(np.float64))
    x = np.random.default_rng(7).normal(size=shape[1]).astype(np.float32)
    np.testing.assert_allclose(top.matvec(x).numpy(), dense @ x, **TOL)
    assert treg.put(r, c, v, shape, spec="auto") == tmid   # still a hit
    # Re-tuning again with a stable ranking is a no-op.
    assert treg.retune(tmid) is False
    assert treg.retune("no-such-matrix") is False


def test_record_observation_feeds_tuner():
    r, c, v, shape = uniform(seed=8)
    _, treg = registries()
    mid = treg.put(r, c, v, shape, spec="auto")
    d = treg.tune_decision(mid)
    assert treg.record_observation(mid, slots_per_s=123.0,
                                   requests_per_s=4.0)
    snap = treg.tuner.snapshot()[d.bucket]
    arm = next(a for a in snap if a["key"] == d.candidate.key)
    assert arm["count"] == 1 and arm["score"] == 123.0


# -- the service ----------------------------------------------------------------
def serve_rounds(svc, mid, xs, pipelined):
    out = []
    for group in xs:
        tickets = [svc.submit(mid, x) for x in group]
        if pipelined:
            with svc:
                out += [svc.result(t, timeout=60) for t in tickets]
        else:
            res = svc.flush()
            out += [res[t] for t in tickets]
    return out


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["sync", "pipelined"])
def test_dispatch_records_observations(pipelined):
    r, c, v, shape = skewed(nnz=700, seed=9)
    jreg, treg = registries()
    mid = treg.put(r, c, v, shape, spec="auto")
    assert jreg.put(r, c, v, shape, spec="auto") == mid
    jsvc = JS.SpMVService(jreg, max_bucket=8, retune_every=4)
    tsvc = TS.SpMVService(treg, max_bucket=8, retune_every=4, device="cpu")
    xs = np.random.default_rng(10).normal(
        size=(3, 2, shape[1])).astype(np.float32)
    want = serve_rounds(jsvc, mid, xs, pipelined=False)
    got = serve_rounds(tsvc, mid, xs, pipelined)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.y, b.y, **TOL)
    snap = tsvc.snapshot()
    assert snap["tuner_observations"] == \
        jsvc.snapshot()["tuner_observations"] == {mid: 3}
    d = treg.tune_decision(mid)
    arm = next(a for a in snap["tuner"][d.bucket]
               if a["key"] == d.candidate.key)
    assert arm["count"] == 3


def test_retune_cadence_swaps_the_served_plan():
    """retune_every=2: after two dispatches the registry re-consults the
    tuner, which a faster arm's observations have flipped; the next
    dispatch runs the new plan and still answers right."""
    r, c, v, shape = skewed(seed=12)
    _, treg = registries()
    mid = treg.put(r, c, v, shape, spec="auto")
    d = treg.tune_decision(mid)
    other = next(cand for cand in treg.tuner.candidates(
        TFE.compute_features(r, c, shape, configs()[1]))
        if cand.key != d.candidate.key)
    treg.tuner.observe(d.bucket, other, slots_per_s=1e15,
                       requests_per_s=1e15)
    svc = TS.SpMVService(treg, max_bucket=4, retune_every=2, device="cpu")
    dense = np.zeros(shape, np.float64)
    np.add.at(dense, (r, c), v.astype(np.float64))
    xs = np.random.default_rng(13).normal(
        size=(3, 2, shape[1])).astype(np.float32)
    res = serve_rounds(svc, mid, xs, pipelined=False)
    for x, got in zip(xs.reshape(-1, shape[1]), res):
        np.testing.assert_allclose(got.y, dense @ x, **TOL)
    assert treg.tune_decision(mid).candidate.key == other.key
    assert svc.snapshot()["tuner_observations"] == {mid: 3}
    assert treg.get(mid).plan.spec == other.spec


def test_retune_every_zero_disables():
    r, c, v, shape = uniform(seed=11)
    _, treg = registries()
    mid = treg.put(r, c, v, shape, spec="auto")
    svc = TS.SpMVService(treg, max_bucket=4, retune_every=0, device="cpu")
    assert svc.retune_every == 0
    x = np.random.default_rng(12).normal(size=shape[1]).astype(np.float32)
    svc.submit(mid, x)
    svc.flush()                     # records, but never retunes
    assert svc.snapshot()["tuner_observations"][mid] == 1
    assert TS.SpMVService(treg, device="cpu").retune_every == 16
    with pytest.raises(ValueError, match="retune_every"):
        TS.SpMVService(treg, retune_every=-1, device="cpu")


def test_manual_entries_have_no_tuner_in_the_snapshot():
    r, c, v, shape = uniform(seed=14)
    _, treg = registries()
    mid = treg.put(r, c, v, shape)
    svc = TS.SpMVService(treg, device="cpu")
    svc.submit(mid, np.ones(shape[1], np.float32))
    svc.flush()
    snap = svc.snapshot()
    assert snap["tuner"] is None and snap["tuner_observations"] == {}
