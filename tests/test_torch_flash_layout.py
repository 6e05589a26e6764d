"""What surrounds the flash-attention kernel, on the CPU: which body the
shape rule picks, and the wgmma body's TMA tensor-map geometry.

The kernel itself runs only on the card (``tests/test_torch_chip.py``);
its plain version is held against the reference's Pallas kernel in
``tests/test_torch_attention.py``.  Here the rule and the geometry, both
plain Python in ``kernels/flash_attention.py``, are checked against the
tensors they describe.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa


def qkv(b, sq, sk, kv, g, dh, dv, dtype=torch.bfloat16, offset=0):
    """q, k, v in the reference layout; ``offset`` elements into their
    storage (contiguous views that start there)."""
    def make(shape):
        n = int(np.prod(shape))
        return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)
    return (make((b, sq, kv, g, dh)), make((b, sk, kv, dh)),
            make((b, sk, kv, dv)))


@pytest.mark.parametrize("dtype,dh,dv,offset,body", [
    (torch.bfloat16, 64, 64, 0, "wgmma"),      # qwen1.5 heads
    (torch.bfloat16, 128, 128, 0, "wgmma"),    # chatglm3, codeqwen1.5
    (torch.bfloat16, 64, 64, 1, "mma"),        # misaligned view
    (torch.bfloat16, 128, 128, 4, "mma"),      # 8-byte aligned only
    (torch.bfloat16, 128, 128, 8, "wgmma"),    # 16-byte aligned view
    (torch.bfloat16, 96, 64, 0, "wgmma"),      # minicpm3's MLA heads
    (torch.bfloat16, 96, 64, 1, "mma"),        # misaligned MLA view
    (torch.bfloat16, 96, 64, 4, "mma"),        # 8-byte aligned only
    (torch.bfloat16, 96, 64, 8, "wgmma"),      # 16-byte aligned view
    (torch.bfloat16, 64, 96, 0, "mma"),        # the pair reversed
    (torch.bfloat16, 128, 64, 0, "mma"),       # a pair it is not built for
    (torch.bfloat16, 64, 128, 0, "mma"),
    (torch.bfloat16, 96, 96, 0, "mma"),        # a head dim it is not built for
    (torch.bfloat16, 32, 32, 0, "mma"),
    (torch.bfloat16, 20, 13, 0, "mma"),        # odd dims
    (torch.bfloat16, 256, 256, 0, "wgmma"),    # paligemma's heads
    (torch.bfloat16, 256, 256, 1, "mma"),      # misaligned paligemma view
    (torch.bfloat16, 256, 128, 0, "mma"),
    (torch.float32, 64, 64, 0, "fma"),
    (torch.float32, 128, 128, 0, "fma"),
    (torch.float32, 64, 64, 1, "fma"),
])
def test_body_follows_dtype_dims_and_alignment(dtype, dh, dv, offset, body):
    q, k, v = qkv(2, 10, 10, 2, 2, dh, dv, dtype, offset)
    assert fa.flash_body(q, k, v) == body


def test_one_misaligned_tensor_is_enough_for_the_mma_body():
    q, k, v = qkv(1, 8, 8, 2, 1, 64, 64)
    _, k_off, _ = qkv(1, 8, 8, 2, 1, 64, 64, offset=1)
    assert fa.flash_body(q, k, v) == "wgmma"
    assert fa.flash_body(q, k_off, v) == "mma"


def served_heads(cfg):
    """(kv heads, group, dh, dv) of the flash kernel's served prefill: MLA
    runs one KV head per query head, dh = rope + nope, dv = v_head_dim."""
    if cfg.mla is not None:
        c = cfg.mla
        return (cfg.num_heads, 1, c.rope_head_dim + c.nope_head_dim,
                c.v_head_dim)
    return (cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads,
            cfg.head_dim, cfg.head_dim)


SERVED = {arch: served_heads(get_config(arch)) for arch in (
    "qwen1.5-0.5b", "chatglm3-6b", "codeqwen1.5-7b", "llama4-scout-17b-a16e",
    "minicpm3-4b", "paligemma-3b")}


def test_minicpm3_heads_are_the_mla_pair():
    assert SERVED["minicpm3-4b"] == (40, 1, 96, 64)
    assert SERVED["llama4-scout-17b-a16e"] == (8, 5, 128, 128)
    geo = fa.tma_geometry(4, 2000, 2000, 40, 1, 96, 64)
    # Q·K's maps: 96 columns in two boxes; P·V's: 64 columns in one.
    assert geo["q"].dims[0] == geo["k"].dims[0] == 96
    assert geo["qk_col_boxes"] == 2
    assert geo["v"].dims[0] == geo["o"].dims[0] == 64
    assert geo["vo_col_boxes"] == 1


def test_paligemma_heads_take_64_key_tiles():
    assert SERVED["paligemma-3b"] == (1, 8, 256, 256)
    geo = fa.tma_geometry(8, 320, 320, 1, 8, 256, 256)
    # Four 64-column boxes on each side; k and v boxes of 64 keys (the
    # pair's tile), q and o boxes of one consumer's 64 rows.
    assert geo["qk_col_boxes"] == geo["vo_col_boxes"] == 4
    assert geo["k"].box == geo["v"].box == (64, 1, 64, 1)
    assert geo["q"].box == geo["o"].box == (64, 1, 64, 1)
    # Every other pair keeps 128-key tiles.
    assert {pair: fa.tma_geometry(1, 8, 8, 1, 1, *pair)["k"].box[2]
            for pair in fa.WGMMA_HEAD_DIMS} == {
        (64, 64): 128, (128, 128): 128, (96, 64): 128, (256, 256): 64}


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_one_misaligned_mla_tensor_is_enough_for_the_mma_body(which):
    aligned = dict(zip("qkv", qkv(1, 8, 8, 4, 1, 96, 64)))
    shifted = dict(zip("qkv", qkv(1, 8, 8, 4, 1, 96, 64, offset=1)))
    assert fa.flash_body(*aligned.values()) == "wgmma"
    mixed = dict(aligned, **{which: shifted[which]})
    assert fa.flash_body(*mixed.values()) == "mma"


@pytest.mark.parametrize("arch", sorted(SERVED))
@pytest.mark.parametrize("b,sq,sk", [(4, 2000, 2000), (1, 32768, 32768),
                                     (2, 77, 260)])
def test_tma_geometry_describes_the_reference_layout(arch, b, sq, sk):
    kvh, g, dh, dv = SERVED[arch]
    assert (dh, dv) in fa.WGMMA_HEAD_DIMS
    geo = fa.tma_geometry(b, sq, sk, kvh, g, dh, dv)
    # Whole 64-column boxes: dh = 96 takes two (TMA fills columns 96-127
    # with zeros), dv = 64 one.
    assert geo["qk_col_boxes"] == -(-dh // 64)
    assert geo["vo_col_boxes"] * 64 == dv
    meta = dict(dtype=torch.bfloat16, device="meta")
    q = torch.empty((b, sq, kvh, g, dh), **meta)
    o = torch.empty((b, sq, kvh, g, dv), **meta)
    k = torch.empty((b, sk, kvh, dh), **meta)
    v = torch.empty((b, sk, kvh, dv), **meta)
    for name, t, heads, rows, d in (("q", q, kvh * g, sq, dh),
                                    ("k", k, kvh, sk, dh),
                                    ("v", v, kvh, sk, dv),
                                    ("o", o, kvh * g, sq, dv)):
        m = geo[name]
        # Innermost first: (d, heads, S, B), with no reshaping copy; the
        # column dim is the tensor's own head dim, never a padded one.
        assert m.dims == (d, heads, rows, b)
        # Byte strides of dims 1-3 are the tensor's own: (G, KV) fold into
        # one heads axis because they are adjacent and contiguous.
        es = t.element_size()
        flat = t.reshape(b, rows, heads, d)
        assert m.strides == tuple(s * es for s in reversed(flat.stride()[:3]))
        assert all(s % 16 == 0 and s < 2 ** 40 for s in m.strides)
        # 128-byte swizzle: the inner box is at most 128 bytes; one head
        # and rows along S, one batch.
        assert m.box[0] * es <= 128 and (m.box[0] * es) % 16 == 0
        assert m.box[1] == 1 and m.box[3] == 1 and 0 < m.box[2] <= 256
    # q and o share their boxes and, at dh = dv, their geometry; k and v
    # likewise.
    assert geo["q"].box == geo["o"].box and geo["k"].box == geo["v"].box
    assert (geo["q"] == geo["o"] and geo["k"] == geo["v"]) == (dh == dv)


@pytest.mark.parametrize("dh,dv", fa.WGMMA_HEAD_DIMS)
def test_tma_geometry_addresses_every_element(dh, dv):
    """Element (b, s, h, c) of each map sits at the byte offset the
    reference layout gives it, for random coordinates across boxes."""
    b, sq, sk, kvh, g = 3, 130, 70, 2, 3
    geo = fa.tma_geometry(b, sq, sk, kvh, g, dh, dv)
    rng = np.random.default_rng(dh + dv)
    for name, rows, heads, d, boxes in (
            ("q", sq, kvh * g, dh, "qk_col_boxes"),
            ("k", sk, kvh, dh, "qk_col_boxes"),
            ("v", sk, kvh, dv, "vo_col_boxes"),
            ("o", sq, kvh * g, dv, "vo_col_boxes")):
        m = geo[name]
        assert m.dims[0] == d and all(s % 16 == 0 for s in m.strides)
        # k and v boxes span the pair's key tile, q and o one consumer's
        # 64 rows.
        assert m.box[2] == (fa._WG_KV_TILE[dh, dv] if name in "kv" else 64)
        ref = torch.arange(b * rows * heads * d).view(b, rows, heads, d)
        for _ in range(50):
            bi, si, hi, ci = (int(rng.integers(n)) for n in
                              (b, rows, heads, d))
            off = 2 * ci + sum(c * s for c, s in
                               zip((hi, si, bi), m.strides))
            assert off % 2 == 0
            assert int(ref[bi, si, hi, ci]) == off // 2
        # Box coordinates: column box j starts 64 columns in, so a head
        # of 128 reads columns [0, 64) and [64, 128) as two boxes, one of
        # 256 four, and one of 96 reads [0, 64) and [64, 96) with the rest
        # of its second box zero.
        assert [j * m.box[0] for j in range(geo[boxes])] == \
            list(range(0, d, 64))


def test_wgmma_head_dims_are_the_served_heads():
    assert sorted({(dh, dv) for _, _, dh, dv in SERVED.values()}) == \
        sorted(fa.WGMMA_HEAD_DIMS)


def test_per_body_counters_start_with_every_body():
    assert set(fa.flash_launches_by_body) == {"wgmma", "mma", "fma"}


def test_cpu_tensors_launch_no_body():
    q, k, v = (torch.randn(t.shape).bfloat16()
               for t in qkv(1, 16, 16, 2, 1, 64, 64))
    before = dict(fa.flash_launches_by_body), fa.flash_launches
    out = fa.flash_attention(q, k, v)
    assert (dict(fa.flash_launches_by_body), fa.flash_launches) == before
    assert torch.equal(out, fa.flash_attention_plain(q, k, v))
