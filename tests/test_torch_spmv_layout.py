"""What surrounds the SpMV stream pass, on the CPU: the lane groups, row
windows and tile splits that :func:`spmv_plan` picks, and the product as
the plan cuts it.

The kernel itself runs only on the card (``tests/test_torch_chip.py``).
Here the plan, plain Python in ``kernels/serpens_spmv.py``, is held to its
rules: every (lane, lane-local row) falls in exactly one (lane group, row
window) cell and every tile in exactly one split; a block's shared
accumulator never exceeds the 232,448 bytes an sm_90 block may use.  A
plain-torch rendering of the decomposition (each cell sums its own slots
into its own accumulator; the cells are then added) is held against
``spmv_plain`` and the reference's ``spmv_pallas`` in interpret mode on the
same seeded stream, at rtol = atol = 1e-5 (fp32 sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import format as F
from repro.core import partition as P
from repro.kernels import serpens_spmv as jk
from repro_torch.kernels import ops
from repro_torch.kernels import serpens_spmv as ks

from torch_port_util import carry_plan, random_coo

SMEM = 232_448             # an sm_90 block's opt-in shared memory
SMS = 132                  # an H100 SXM's SMs
TOL = dict(rtol=1e-5, atol=1e-5)

# (num_tiles, sub, lanes, num_rows_padded) of the geometries the plan must
# handle: the G7 stand-in at the default config (1,630,080 rows, 268.3 MB
# stream), the G5 stand-in, the card tests' tpc2 config, an odd lane count
# and 65,536 lane-local rows (row 0xFFFF), which not even one lane fits.
GEOMETRIES = {
    "G7": (32_751, 8, 128, 1_630_080),
    "G5": (26_000, 8, 128, 377_088),
    "tpc2": (40, 8, 16, 3_008),
    "odd-lanes": (50, 4, 7, 3_003),
    "rows-65536": (10, 4, 8, 8 * 65_536),
}


def cover(plan, num_tiles):
    """How often each (lane, lane-local row) is owned by a (group, window)
    cell and each tile by a split."""
    cells = np.zeros((plan.lanes, plan.rows), np.int64)
    for lo, hi in plan.groups:
        for rlo, rhi in plan.windows:
            cells[lo:hi, rlo:rhi] += 1
    tiles = np.zeros(num_tiles, np.int64)
    for t0, t1 in plan.tile_ranges(num_tiles):
        tiles[t0:t1] += 1
    return cells, tiles


@pytest.mark.parametrize("sms", [SMS, 114, 1])
@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
def test_cells_and_splits_partition_the_work(geo, sms):
    num_tiles, sub, lanes, rows_padded = GEOMETRIES[geo]
    plan = ks.spmv_plan(num_tiles, sub, lanes, rows_padded, SMEM, sms)
    assert plan.lanes == lanes and plan.rows == -(-rows_padded // lanes)
    cells, tiles = cover(plan, num_tiles)
    assert (cells == 1).all() and (tiles == 1).all()
    widest = max(hi - lo for lo, hi in plan.windows)
    assert plan.smem_bytes == plan.lane_group * widest * 4 <= SMEM
    assert plan.blocks == len(plan.groups) * len(plan.windows) * plan.splits
    # About one block per SM: as many splits as the cells leave room for.
    cells_n = len(plan.groups) * len(plan.windows)
    assert plan.splits == max(1, min(num_tiles, sms // cells_n))


@pytest.mark.parametrize("geo,lane_group,windows,splits", [
    ("G7", 4, 1, 4),            # 203,760 B of shared accumulator
    ("G5", 16, 1, 16),          # 188,544 B
    ("tpc2", 16, 1, 40),        # every lane fits; a split per tile
    ("odd-lanes", 7, 1, 50),
    ("rows-65536", 1, 2, 8),    # 256 KB per lane: two windows
])
def test_plan_at_the_served_geometries(geo, lane_group, windows, splits):
    plan = ks.spmv_plan(*GEOMETRIES[geo], SMEM, SMS)
    assert (plan.lane_group, len(plan.windows), plan.splits) == (
        lane_group, windows, splits)


@pytest.mark.parametrize("lanes", [1, 4, 7, 16, 128, 200, 2048])
@pytest.mark.parametrize("rows", [1, 100, 2_946, 12_735, 14_530, 29_056,
                                  58_112, 58_113, 65_536])
def test_lane_group_and_windows_rule(lanes, rows):
    """The largest group whose rows fit, at most 1024 lanes (a thread a
    lane), rounded down to a multiple of 8 (one 32-byte sector of idx) or
    else of 4, unless it takes every lane; one lane in the fewest equal
    windows when not even one lane fits."""
    plan = ks.spmv_plan(64, 8, lanes, rows * lanes, SMEM, SMS)
    fit = min(SMEM // 4 // rows, 1024)         # one thread a lane
    assert plan.smem_bytes <= SMEM
    if fit >= 1:
        assert len(plan.windows) == 1
        want = lanes if fit >= lanes else (fit // 8 * 8 or fit // 4 * 4
                                           or fit)
        assert plan.lane_group == want
    else:
        assert plan.lane_group == 1
        sizes = [hi - lo for lo, hi in plan.windows]
        assert max(sizes) * 4 <= SMEM < -(-rows // (len(sizes) - 1)) * 4
        assert max(sizes) - min(sizes) <= 1


def test_an_empty_stream_is_one_split():
    """With no tiles the pass only writes the zero accumulator."""
    plan = ks.spmv_plan(0, 8, 128, 1024, SMEM, SMS)
    assert (plan.splits, plan.blocks) == (1, 1)


def test_plan_refuses_2_31_slots():
    with pytest.raises(ValueError, match="2\\^31"):
        ks.spmv_plan(1 << 21, 8, 128, 1 << 20, SMEM, SMS)


# -- the decomposition against spmv_plain and the reference ------------------
SMALL = dict(segment_width=64, lanes=8, sublanes=4, raw_window=4)
CONFIGS = {
    "small": F.SerpensConfig(**SMALL),
    "tpc2": F.SerpensConfig(segment_width=128, lanes=16, sublanes=8,
                            tiles_per_chunk=2),
    "raw2-bf16": F.SerpensConfig(**dict(SMALL, raw_window=2),
                                 value_dtype="bfloat16"),
    "odd-lanes": F.SerpensConfig(**dict(SMALL, lanes=7)),
}
# Plans forced on each stream beside its own: (lane_group, windows,
# splits).  Several windows, several splits, one lane, and groups of 3 (a
# partial last group at 8 and 16 lanes) and 4.
FORCED = [(1, 3, 2), (4, 2, 3), (3, 1, 5), (8, 4, 1), (16, 2, 7),
          (2, 1, 3)]


def stream(name, m=150, k=300, nnz=1500, seed=1):
    cfg = CONFIGS[name]
    r, c, v = random_coo(m, k, nnz, seed=seed, hot_rows=3)
    jplan = P.make_plan(r, c, v, (m, k), cfg, P.PlanSpec())
    tplan = carry_plan(jplan)
    idx, val, seg = ops.device_arrays(tplan.shards[0], "cpu")
    kp = jplan.num_segments_local * cfg.segment_width
    x = np.random.default_rng(seed + 1).normal(size=kp).astype(np.float32)
    x[k:] = 0.0
    return jplan, (idx, val, seg), x


def spmv_by_cells(idx, val, seg, x, plan, *, num_rows_padded,
                  segment_width):
    """The product as the plan cuts it: each (group, window, split) cell
    sums the slots of its lanes, rows and tiles into its own (window rows,
    group lanes) accumulator, as one block does in shared memory; then the
    cells are added."""
    lanes = idx.shape[2]
    live = idx != -1
    w = idx.to(torch.int64) & 0xFFFFFFFF
    rows = torch.where(live, w >> 16, -1)
    cols = seg.to(torch.int64)[:, None, None] * segment_width + (w & 0xFFFF)
    contrib = torch.where(live, val.float() * x[torch.where(live, cols, 0)],
                          0.0)
    acc = torch.zeros(plan.rows * lanes, dtype=torch.float32)
    for t0, t1 in plan.tile_ranges(idx.shape[0]):
        for lo, hi in plan.groups:
            for rlo, rhi in plan.windows:
                r = rows[t0:t1, :, lo:hi]
                keep = (r >= rlo) & (r < rhi)
                lane = torch.arange(lo, hi).expand_as(r)
                cell = torch.zeros((rhi - rlo, hi - lo), dtype=torch.float32)
                cell.index_put_((r[keep] - rlo, lane[keep] - lo),
                                contrib[t0:t1, :, lo:hi][keep],
                                accumulate=True)
                acc.view(plan.rows, lanes)[rlo:rhi, lo:hi] += cell
    return acc[:num_rows_padded]


_PALLAS: dict = {}


def pallas_want(name, jplan, x):
    """The reference's ``spmv_pallas`` in interpret mode, once per
    stream."""
    if name not in _PALLAS:
        cfg, sm = jplan.config, jplan.shards[0]
        _PALLAS[name] = np.asarray(jk.spmv_pallas(
            jnp.asarray(sm.idx), jnp.asarray(sm.val),
            jnp.asarray(sm.seg_ids[::cfg.tiles_per_chunk]),
            jnp.asarray(x).reshape(-1, cfg.segment_width),
            num_rows_padded=jplan.out_rows_padded,
            segment_width=cfg.segment_width,
            tiles_per_chunk=cfg.tiles_per_chunk, interpret=True))
    return _PALLAS[name]


@pytest.mark.parametrize("forced", [None] + FORCED,
                         ids=["planned"] + [f"lg{g}-w{w}-s{s}"
                                            for g, w, s in FORCED])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_decomposition_matches_plain_and_pallas(name, forced):
    jplan, (idx, val, seg), x = stream(name)
    cfg = jplan.config
    geo = dict(num_rows_padded=jplan.out_rows_padded,
               segment_width=cfg.segment_width)
    num_tiles, sub, lanes = idx.shape
    if forced is None:
        plan = ks.spmv_plan(num_tiles, sub, lanes, geo["num_rows_padded"],
                            SMEM, SMS)
    else:
        lg, windows, splits = forced
        plan = ks.spmv_plan_of(lanes, geo["num_rows_padded"], min(lg, lanes),
                               windows, splits)
    cells, tiles = cover(plan, num_tiles)
    assert (cells == 1).all() and (tiles == 1).all()
    got = spmv_by_cells(idx, val, seg, torch.from_numpy(x), plan, **geo)
    plain = ks.spmv(idx, val, seg, torch.from_numpy(x),
                    tiles_per_chunk=cfg.tiles_per_chunk, **geo)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), pallas_want(name, jplan, x),
                               **TOL)


def test_forced_plan_of_another_geometry_is_refused():
    """A plan must match the stream's lanes and rows, and its windows must
    be the equal cut the kernel makes; both are checked before any
    launch."""
    _, (idx, val, seg), x = stream("small")
    geo = dict(num_rows_padded=152, segment_width=64)
    lanes = idx.shape[2]
    bad = [ks.spmv_plan_of(lanes + 1, 152, 1, 1, 1),
           ks.spmv_plan_of(lanes, 1024, 1, 1, 1)]
    good = ks.spmv_plan_of(lanes, 152, 2, 3, 1)
    bad.append(ks.SpmvPlan(**dict(vars(good), windows=((0, 5), (5, 19)))))
    for plan in bad:
        with pytest.raises(ValueError, match="does not fit"):
            ks._spmv_run(idx, val, seg, torch.from_numpy(x), plan, **geo)


def test_the_cpu_path_launches_nothing():
    _, (idx, val, seg), x = stream("small")
    before = (ks.spmv_launches, ks.spmv_last_plan)
    got = ks.spmv(idx, val, seg, torch.from_numpy(x), num_rows_padded=152,
                  segment_width=64)
    assert got.shape == (152,) and bool(torch.isfinite(got).all())
    assert (ks.spmv_launches, ks.spmv_last_plan) == before
