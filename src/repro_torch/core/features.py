"""Structural matrix features — the auto-tuner's input.

"Feature-based SpMV Performance Analysis on Contemporary Devices"
(PAPERS.md) shows a handful of cheap structural features (nnz/row
distribution, row imbalance, bandwidth, density) predict which SpMV
configuration wins on a given device.  This module extracts exactly that
record from the triples the encode pipeline already holds:
:func:`features_of` runs at ``prepare`` time for near-free — the bucket
sort in :func:`repro_torch.core.format.prepare` has already materialized
the per-(segment, lane) bucket key, so the per-segment and per-lane counts
fall out of one ``bincount`` — and the result is cached on the
:class:`~repro_torch.core.format.PreparedCOO`, so repartitions reuse it
and a delta (which builds a fresh ``PreparedCOO``) naturally invalidates
it.  The thresholds and the bucket strings are the JAX reference's, so a
bucket names the same matrices in both packages.

Everything here is plain numpy: worker processes and the tuner must never
pull in torch just to bucket a matrix.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core import format as sformat

#: Discretization thresholds of :meth:`MatrixFeatures.bucket`.  Coarse on
#: purpose — the tuner's measured prior keys on the bucket string, so a
#: finer grid fragments the observations it can generalize from.
CV_THRESHOLDS = (0.5, 1.25)          # lo | mid | hi nnz/row variation
BANDWIDTH_THRESHOLDS = (0.02, 0.15)  # band | local | scattered


@dataclasses.dataclass(frozen=True)
class MatrixFeatures:
    """Structural summary of one sparse matrix under one stream geometry.

    All ratios are dimensionless; distance-like features are normalized
    by the matrix extent, so the same structure at two scales lands in
    the same :meth:`bucket` as long as it spans a comparable number of
    column segments (the one geometry-coupled bucket dimension).
    """

    shape: tuple[int, int]
    nnz: int
    density: float            # nnz / (M * K)
    nnz_row_mean: float       # nnz / M
    nnz_row_cv: float         # std/mean of per-row nnz counts (0 rows incl.)
    nnz_row_max: int
    gini: float               # Gini coefficient of per-row nnz (0 = even)
    bandwidth: float          # mean normalized diagonal distance |r/M - c/K|
    segment_locality: float   # 1 - normalized entropy of per-segment counts
    lane_imbalance: float     # max/mean per-lane nnz under the modulo split
    num_segments: int         # column segments under this config

    def bucket(self) -> str:
        """Coarse feature-bucket key the tuner's prior is indexed by."""
        m, k = self.shape
        if m >= 4 * k:
            aspect = "tall"
        elif k >= 4 * m:
            aspect = "wide"
        else:
            aspect = "sq"
        if self.nnz == 0 or self.density <= 0.0:
            dens = "d-empty"
        else:
            mag = int(math.floor(math.log10(self.density)))
            dens = f"d{max(-8, min(0, mag))}"
        lo, hi = CV_THRESHOLDS
        cv = "cv-lo" if self.nnz_row_cv < lo else (
            "cv-mid" if self.nnz_row_cv < hi else "cv-hi")
        lo, hi = BANDWIDTH_THRESHOLDS
        bw = "bw-band" if self.bandwidth <= lo else (
            "bw-loc" if self.bandwidth <= hi else "bw-scat")
        # Segment count is the one geometry-coupled dimension: how many
        # column segments x is re-streamed across changes which layout
        # wins (a single-segment matrix has no x-reuse problem at all),
        # so matrices on either side must not share a prior row.
        if self.num_segments <= 1:
            seg = "s1"
        elif self.num_segments <= 8:
            seg = "s-few"
        else:
            seg = "s-many"
        return f"{aspect}|{dens}|{cv}|{bw}|{seg}"

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["shape"] = [int(s) for s in self.shape]
        d["bucket"] = self.bucket()
        return d


def _gini(counts: np.ndarray) -> float:
    """Gini coefficient of a non-negative count vector (0 = uniform)."""
    n = counts.size
    total = float(counts.sum())
    if n == 0 or total <= 0.0:
        return 0.0
    c = np.sort(counts.astype(np.float64))
    i = np.arange(1, n + 1, dtype=np.float64)
    return float(((2.0 * i - n - 1.0) * c).sum() / (n * total))


def compute_features(rows, cols, shape, config: sformat.SerpensConfig,
                     *, bucket_key: np.ndarray | None = None
                     ) -> MatrixFeatures:
    """Compute the feature record from raw (validated) COO coordinates.

    ``bucket_key`` — the cached per-entry ``segment * lanes + lane`` key
    from :func:`repro_torch.core.format.prepare` — supplies the
    per-segment and per-lane counts in one ``bincount`` when available;
    otherwise they are rebuilt from the coordinates (same values, one
    extra pass).
    """
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    m, k = int(shape[0]), int(shape[1])
    w, lanes = config.segment_width, config.lanes
    nseg = max(1, -(-k // w))
    nnz = int(rows.size)

    row_counts = (np.bincount(rows, minlength=m) if nnz
                  else np.zeros(m, np.int64))
    mean = nnz / m if m else 0.0
    if mean > 0.0:
        cv = float(row_counts.std() / mean)
    else:
        cv = 0.0

    if bucket_key is not None:
        bc = np.bincount(bucket_key, minlength=nseg * lanes)
        bc = bc.reshape(nseg, lanes)
        seg_counts = bc.sum(axis=1)
        lane_counts = bc.sum(axis=0)
    elif nnz:
        seg_counts = np.bincount(sformat.seg_of(cols, w), minlength=nseg)
        lane_counts = np.bincount(rows % lanes, minlength=lanes)
    else:
        seg_counts = np.zeros(nseg, np.int64)
        lane_counts = np.zeros(lanes, np.int64)

    if nnz and m > 1 and k > 1:
        bandwidth = float(np.abs(rows / (m - 1) - cols / (k - 1)).mean())
    else:
        bandwidth = 0.0

    if nnz and nseg > 1:
        p = seg_counts[seg_counts > 0].astype(np.float64) / nnz
        entropy = float(-(p * np.log(p)).sum())
        locality = 1.0 - entropy / math.log(nseg)
    else:
        locality = 1.0
    lane_mean = float(lane_counts.mean())
    lane_imb = (float(lane_counts.max() / lane_mean) if lane_mean > 0.0
                else 1.0)

    return MatrixFeatures(
        shape=(m, k), nnz=nnz,
        density=nnz / (m * k) if m and k else 0.0,
        nnz_row_mean=mean, nnz_row_cv=cv,
        nnz_row_max=int(row_counts.max()) if m else 0,
        gini=_gini(row_counts), bandwidth=bandwidth,
        segment_locality=locality, lane_imbalance=lane_imb,
        num_segments=nseg)


def features_of(prep: sformat.PreparedCOO) -> MatrixFeatures:
    """Features of a prepared matrix, cached on the ``PreparedCOO``."""
    if prep.features is None:
        prep.features = compute_features(
            prep.rows, prep.cols, prep.shape, prep.config,
            bucket_key=prep.bucket_key)
    return prep.features
