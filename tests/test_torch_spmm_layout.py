"""What surrounds the SpMM kernel, on the CPU: the vector width and the
row windows that :func:`spmm_plan` picks.

The kernel itself runs only on the card (``tests/test_torch_chip.py``);
its plain version is held against the reference's Pallas kernel in
``tests/test_torch_kernels.py``.  Here the plan, plain Python in
``kernels/serpens_spmv.py``, is checked against the X it describes and
the L2 rule: one pass while the fp32 acc ``R_pad × N`` fits half the L2,
else the fewest equal windows of rows whose acc does.
"""
import pytest
import torch

from repro_torch.kernels import serpens_spmv as ks

L2 = 52_428_800            # an H100's L2_cache_size, 50 MiB
G7_ROWS = 1_630_080        # the G7 stand-in's padded rows at the default
SMALL_ROWS = 1024


def xmat(n, offset=0, rows=16):
    """A (rows, n) float32 X that starts ``offset`` elements into its
    storage (a contiguous view, as a slice of a padded buffer gives)."""
    return torch.zeros(rows * n + offset)[offset:].view(rows, n)


@pytest.mark.parametrize("n,offset,vec", [
    (1, 0, 1), (2, 0, 2), (3, 0, 1), (4, 0, 4), (5, 0, 1), (8, 0, 4),
    (16, 0, 4), (17, 0, 1), (64, 0, 4),
    (16, 1, 1),            # 4-byte aligned only
    (16, 2, 2),            # 8-byte aligned
    (16, 4, 4),            # 16-byte aligned view
    (8, 3, 1), (2, 1, 1), (4, 2, 2), (64, 6, 2), (6, 0, 2), (6, 2, 2),
])
@pytest.mark.parametrize("rows", [SMALL_ROWS, G7_ROWS])
def test_vector_width_follows_n_and_alignment(n, offset, vec, rows):
    x = xmat(n, offset)
    assert x.is_contiguous() and x.storage_offset() == offset
    assert ks.spmm_plan(x, rows, L2).vec == vec


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8, 16, 17, 64])
def test_one_pass_while_acc_fits_half_the_l2(n):
    assert ks.spmm_plan(xmat(n), SMALL_ROWS, L2).windows == (
        (0, SMALL_ROWS),)


@pytest.mark.parametrize("n,passes", [
    (1, 1), (2, 1), (3, 1),               # 19.6 MB of acc: one pass
    (4, 1),                               # 26.1 MB, just inside 26.2 MB
    (5, 2), (8, 2), (16, 4), (17, 5), (64, 16),
])
def test_row_windows_at_g7(n, passes):
    windows = ks.spmm_plan(xmat(n), G7_ROWS, L2).windows
    assert len(windows) == passes
    assert windows[0][0] == 0 and windows[-1][1] == G7_ROWS


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8, 16, 17, 64])
@pytest.mark.parametrize("rows", [128, 200_000, G7_ROWS, 4_000_000,
                                  20_000_000])
@pytest.mark.parametrize("offset", [0, 1, 2])
def test_windows_cover_the_rows_in_the_fewest_passes(n, rows, offset):
    windows = ks.spmm_plan(xmat(n, offset), rows, L2).windows
    assert windows[0][0] == 0 and windows[-1][1] == rows
    assert all(a[1] == b[0] for a, b in zip(windows, windows[1:]))
    sizes = [hi - lo for lo, hi in windows]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1   # equal
    assert all(size * n * 4 <= L2 // 2 for size in sizes)
    if len(windows) > 1:          # one window fewer would not fit
        assert -(-rows // (len(windows) - 1)) * n * 4 > L2 // 2


def test_the_cpu_path_launches_nothing():
    idx = torch.full((1, 2, 4), -1, dtype=torch.int32)
    val = torch.zeros((1, 2, 4))
    seg = torch.zeros(1, dtype=torch.int32)
    before = (ks.spmm_launches, dict(ks.spmm_launches_by_width))
    got = ks.spmm(idx, val, seg, torch.ones(8, 4), num_rows_padded=8,
                  segment_width=8)
    assert got.shape == (8, 4) and float(got.abs().sum()) == 0.0
    assert (ks.spmm_launches, ks.spmm_launches_by_width) == before
