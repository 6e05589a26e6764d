"""Feature-driven plan auto-tuning.

"Feature-based SpMV Performance Analysis on Contemporary Devices"
(PAPERS.md) motivates the shape of this tier: a handful of cheap
structural features (:mod:`repro_torch.core.features`) predict which SpMV
configuration wins, so instead of a hand-picked ``PlanSpec`` the caller
says ``spec="auto"`` and :class:`PlanTuner` maps the matrix's *feature
bucket* to a ranked list of :class:`TunerCandidate` configs:

1. **Prior** — a measured table (feature bucket ``aspect|dens|cv|bw|seg``
   → candidate scores) in the JSON form of :meth:`PlanTuner.to_json`;
   unseen buckets fall back to feature heuristics
   (:func:`default_candidates`).
2. **Online** — the registry/service record observed slots/s after every
   dispatch (:meth:`PlanTuner.observe`); scores are EWMAs, so a matrix
   whose bucket mis-predicts converges to its true winner after a few
   re-probes.
3. **Exploration** — epsilon-greedy: with probability ``epsilon`` a
   choice probes the least-observed non-best arm, so a seeded-wrong
   prior cannot lock in forever.

The tuner is process-wide state shared across matrices: everything is
guarded by one lock, and observation metrics land on ``repro_torch.obs``
(decision counter + predicted-vs-observed ratio histogram) so mispredicts
are visible in production stats.

This is the JAX reference's tuner with one change of input: the backend
comes from the caller (the registry passes the one it resolved from its
device), and must be one of this package's, ``"cuda"`` or ``"torch"``.
A prior measured for a JAX backend (``"xla"``, ``"pallas"``) ranks plans
on another device and is refused, as is one measured for the other port
backend.  The module is plain Python, like the features it reads.
"""
from __future__ import annotations

import dataclasses
import json
import random
import threading

from repro_torch import obs
from repro_torch.core import partition as cpart
from repro_torch.core.features import MatrixFeatures

#: Predicted-over-observed slots/s ratio buckets — log-ish spacing around
#: 1.0 so both "prior was right" and order-of-magnitude mispredicts are
#: visible in one histogram.
RATIO_BUCKETS = (0.125, 0.25, 0.5, 0.71, 0.9, 1.1, 1.4, 2.0, 4.0, 8.0)

#: The port's backends (``repro_torch.kernels.ops.BACKENDS``, kept here so
#: the tuner imports no torch).
BACKENDS = ("cuda", "torch")


def _check_backend(backend) -> str:
    """``backend`` if it names a port backend; ``ValueError`` otherwise."""
    if backend in ("xla", "pallas"):
        raise ValueError(
            f"backend {backend!r} is a JAX backend of the reference "
            f"package; this package's tuner ranks 'cuda' or 'torch' plans")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; known: {BACKENDS}")
    return backend


@dataclasses.dataclass(frozen=True)
class TunerCandidate:
    """One (PlanSpec, backend, config-override) arm the tuner can pick.

    ``spill``/``lane_balance``/``raw_window`` are optional
    :class:`~repro_torch.core.format.SerpensConfig` overrides applied on
    top of the registry's base config (``None`` keeps the base value).
    The reference sets ``raw_window`` only for its XLA backend, because
    its Pallas kernel needs the schedule's tile depth to equal the sublane
    count; neither port backend has that constraint, so both take the
    reference's XLA arms.
    """

    partition: str = "single"
    num_shards: int = 1
    lane_assign: str = "modulo"
    backend: str = "cuda"
    spill: bool | None = None
    lane_balance: float | None = None
    raw_window: int | None = None

    @property
    def spec(self) -> cpart.PlanSpec:
        return cpart.PlanSpec(self.partition, self.num_shards,
                              self.lane_assign)

    @property
    def key(self) -> str:
        """Stable identity string (JSON dict key / metrics label)."""
        s = f"{self.partition}:{self.num_shards}:{self.lane_assign}" \
            f"@{self.backend}"
        if self.spill:
            s += "+spill"
        if self.lane_balance is not None:
            s += f"+lb={self.lane_balance:g}"
        if self.raw_window is not None:
            s += f"+T={self.raw_window}"
        return s

    def apply_config(self, config):
        """Base :class:`SerpensConfig` + this candidate's overrides."""
        kw = {}
        if self.spill is not None:
            kw["spill_hot_rows"] = self.spill
        if self.lane_balance is not None:
            kw["lane_balance"] = self.lane_balance
        if self.raw_window is not None:
            kw["raw_window"] = self.raw_window
        return dataclasses.replace(config, **kw) if kw else config

    def to_dict(self) -> dict:
        d = {"partition": self.partition, "num_shards": self.num_shards,
             "lane_assign": self.lane_assign, "backend": self.backend}
        for f in ("spill", "lane_balance", "raw_window"):
            v = getattr(self, f)
            if v is not None:
                d[f] = v
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TunerCandidate":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)
                      if f.name in d})


@dataclasses.dataclass
class _Arm:
    """Mutable per-(bucket, candidate) state."""

    cand: TunerCandidate
    rank: int                    # heuristic/prior order (exploit tiebreak)
    score: float = 0.0           # EWMA of observed slots/s
    count: int = 0               # observations folded into the score
    requests_per_s: float = 0.0  # EWMA, informational only


@dataclasses.dataclass(frozen=True)
class TuneDecision:
    """What the tuner picked for one matrix, carried on registry entries."""

    bucket: str
    candidate: TunerCandidate
    predicted: float             # EWMA slots/s at decision time (0 = none)
    explored: bool               # epsilon-probe, not the greedy choice
    ranked: tuple[str, ...]      # candidate keys, best first

    def to_dict(self) -> dict:
        return {"bucket": self.bucket,
                "candidate": self.candidate.to_dict(),
                "key": self.candidate.key,
                "predicted_slots_per_s": self.predicted,
                "explored": self.explored,
                "ranked": list(self.ranked)}


def default_candidates(features: MatrixFeatures,
                       backend: str) -> list[TunerCandidate]:
    """Heuristic candidate list for a bucket with no measured prior.

    The order encodes the feature analysis: skewed nnz/row distributions
    (power-law graphs) lead with balanced lanes + hot-row spill — exactly
    where the modulo lane split pads worst; banded/local matrices lead
    with a column split (x reuse inside narrow segments); everything
    always includes the plain single-shard stream in both lane modes so
    the online loop can discover that the clever layouts don't pay.

    ``backend`` is ``"cuda"`` or ``"torch"``; both get the reference's
    list for its XLA backend, raw-window-2 arms included (see
    :class:`TunerCandidate`).
    """
    be = _check_backend(backend)
    tw = {"raw_window": 2}
    out: list[TunerCandidate] = []
    skewed = features.nnz_row_cv >= 1.0 or features.gini >= 0.6
    banded = (features.bandwidth <= 0.02 and features.nnz_row_cv < 1.0
              and features.num_segments >= 2)
    if skewed:
        out += [
            TunerCandidate("single", 1, "balanced", be, spill=True,
                           lane_balance=1.25, **tw),
            TunerCandidate("single", 1, "balanced", be),
            TunerCandidate("single", 1, "modulo", be, spill=True,
                           lane_balance=1.1, **tw),
        ]
    if banded:
        out += [
            TunerCandidate("col", 2, "modulo", be, **tw),
            TunerCandidate("single", 1, "modulo", be, **tw),
        ]
    # No backend of the port has a physical RAW pipeline hazard, so a
    # shrunken cooldown window is a straight slot-count win on any
    # structure.
    out += [
        TunerCandidate("single", 1, "modulo", be, **tw),
        TunerCandidate("single", 1, "modulo", be),
        TunerCandidate("single", 1, "balanced", be),
        TunerCandidate("row", 2, "modulo", be),
    ]
    seen: set[str] = set()
    uniq = []
    for c in out:
        if c.key not in seen:
            seen.add(c.key)
            uniq.append(c)
    return uniq


class PlanTuner:
    """Bucketed epsilon-greedy tuner over (PlanSpec, backend) candidates.

    ``backend`` (``"cuda"`` or ``"torch"``) is the one the arms run on:
    the registry's, resolved from its device.  ``prior`` is the JSON
    object produced by :meth:`to_json` (or a sweep artifact wrapping it
    under a ``"prior"`` key); an arm measured for another backend is
    refused with ``ValueError``.  Thread-safe; one instance is meant to be
    shared by a registry + service pair.
    """

    def __init__(self, prior: dict | None = None, *, backend: str,
                 epsilon: float = 0.1, alpha: float = 0.5, seed: int = 0,
                 metrics=None):
        if not 0.0 <= epsilon < 1.0:
            raise ValueError(f"epsilon must be in [0, 1), got {epsilon}")
        self.backend = _check_backend(backend)
        self.epsilon = float(epsilon)
        self.alpha = float(alpha)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._arms: dict[str, dict[str, _Arm]] = {}
        if metrics is None:
            metrics = obs.REGISTRY
        self._decisions = metrics.counter(
            "tuner_decisions_total",
            "auto-tune decisions by feature bucket and explore flag")
        self._retunes = metrics.counter(
            "tuner_retunes_total", "online re-tune plan swaps")
        self._ratio = metrics.histogram(
            "tuner_predicted_over_observed_ratio",
            "predicted / observed slots/s per observation",
            buckets=RATIO_BUCKETS)
        if prior is not None:
            self._load_prior(prior)

    # -- candidate management ---------------------------------------------
    def _bucket_arms(self, features: MatrixFeatures) -> dict[str, _Arm]:
        bucket = features.bucket()
        arms = self._arms.get(bucket)
        if arms is None:
            arms = self._arms[bucket] = {}
        for c in default_candidates(features, self.backend):
            if c.key not in arms:
                arms[c.key] = _Arm(c, rank=len(arms))
        return arms

    def candidates(self, features: MatrixFeatures) -> list[TunerCandidate]:
        """All candidate arms for this matrix's bucket (seeding it if
        new), in current ranked order — a sweep measures exactly these."""
        with self._lock:
            arms = self._bucket_arms(features)
            return [a.cand for a in self._ranked(arms)]

    @staticmethod
    def _exploit_score(a: _Arm) -> float:
        # Rank by requests/s — the serving objective.  Raw slots/s would
        # reward a candidate for its *own* padding (same wall time, more
        # padded slots, higher "throughput"), inverting the ranking
        # exactly where balanced lanes shrink the stream.  slots/s stays
        # recorded per arm for the bandwidth story and the
        # predicted-vs-observed histogram; it is only the fallback for
        # prior entries that recorded no request rate.
        return a.requests_per_s if a.requests_per_s > 0.0 else a.score

    @staticmethod
    def _ranked(arms: dict[str, _Arm]) -> list[_Arm]:
        # Measured arms (best first) ahead of unmeasured ones (heuristic
        # rank order).
        return sorted(
            arms.values(),
            key=lambda a: ((0, -PlanTuner._exploit_score(a))
                           if a.count else (1, a.rank)))

    # -- decide / learn ---------------------------------------------------
    def choose(self, features: MatrixFeatures, *,
               explore: bool = True) -> TuneDecision:
        """Pick a candidate for this matrix.

        Greedy on the ranked arms; with probability ``epsilon`` (and only
        when ``explore``) probes the least-observed non-best arm instead.
        """
        with self._lock:
            arms = self._bucket_arms(features)
            ranked = self._ranked(arms)
            best, rest = ranked[0], ranked[1:]
            pick, explored = best, False
            if explore and rest and self._rng.random() < self.epsilon:
                pick = min(rest, key=lambda a: (a.count, a.rank))
                explored = True
            bucket = features.bucket()
            self._decisions.inc(bucket=bucket,
                                explored=str(explored).lower())
            return TuneDecision(
                bucket=bucket, candidate=pick.cand,
                predicted=pick.score if pick.count else 0.0,
                explored=explored,
                ranked=tuple(a.cand.key for a in ranked))

    def observe(self, bucket: str, candidate: TunerCandidate,
                slots_per_s: float, requests_per_s: float | None = None,
                predicted: float | None = None) -> None:
        """Fold one measured dispatch into the (bucket, candidate) arm."""
        if slots_per_s <= 0.0:
            return
        with self._lock:
            arms = self._arms.setdefault(bucket, {})
            arm = arms.get(candidate.key)
            if arm is None:
                arm = arms[candidate.key] = _Arm(candidate, rank=len(arms))
            a = self.alpha
            if arm.count == 0:
                arm.score = slots_per_s
                if requests_per_s:
                    arm.requests_per_s = requests_per_s
            else:
                arm.score += a * (slots_per_s - arm.score)
                if requests_per_s:
                    arm.requests_per_s += a * (requests_per_s
                                               - arm.requests_per_s)
            arm.count += 1
        if predicted and predicted > 0.0:
            self._ratio.observe(predicted / slots_per_s)

    def record_retune(self, bucket: str) -> None:
        """Count an online plan swap (the registry re-encoded a matrix
        because the tuner's ranking changed under it)."""
        self._retunes.inc(bucket=bucket)

    # -- persistence ------------------------------------------------------
    def to_json(self) -> dict:
        with self._lock:
            return {"version": 1, "alpha": self.alpha,
                    "buckets": {
                        bucket: [{"candidate": a.cand.to_dict(),
                                  "score": a.score, "count": a.count,
                                  "requests_per_s": a.requests_per_s}
                                 for a in self._ranked(arms)]
                        for bucket, arms in sorted(self._arms.items())}}

    def _load_prior(self, prior: dict) -> None:
        if "prior" in prior and "buckets" not in prior:
            prior = prior["prior"]  # sweep artifact wraps the prior
        buckets = prior.get("buckets", {})
        with self._lock:
            for bucket, entries in buckets.items():
                arms = self._arms.setdefault(bucket, {})
                for e in entries:
                    c = TunerCandidate.from_dict(e["candidate"])
                    if _check_backend(c.backend) != self.backend:
                        raise ValueError(
                            f"prior arm {c.key!r} was measured on backend "
                            f"{c.backend!r}; this tuner ranks "
                            f"{self.backend!r} plans")
                    if c.key in arms:
                        continue
                    arms[c.key] = _Arm(
                        c, rank=len(arms),
                        score=float(e.get("score", 0.0)),
                        count=int(e.get("count", 0)),
                        requests_per_s=float(e.get("requests_per_s", 0.0)))

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")

    @classmethod
    def from_json(cls, obj: dict, **kw) -> "PlanTuner":
        return cls(prior=obj, **kw)

    @classmethod
    def load(cls, path, **kw) -> "PlanTuner":
        with open(path) as f:
            return cls(prior=json.load(f), **kw)

    # -- introspection ----------------------------------------------------
    def snapshot(self) -> dict:
        """Per-bucket ranked arms for ``SpMVService.snapshot()``."""
        with self._lock:
            return {
                bucket: [{"key": a.cand.key, "score": a.score,
                          "count": a.count}
                         for a in self._ranked(arms)]
                for bucket, arms in sorted(self._arms.items())}
