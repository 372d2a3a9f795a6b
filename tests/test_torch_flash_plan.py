"""The flash-attention wrapper's plan, on the CPU (no card needed): which
kernel each call goes to, how the decode kernels cut the keys, which tiles
they skip, and the split decode kernel's split-then-merge arithmetic in
plain PyTorch (``ref.split_decode_ref``) against the reference's Pallas
kernel in interpret mode and its dense attention (the warp decode kernel's:
tests/test_torch_flash_decode.py).

Tolerance: fp32 2e-5, absolute and relative (tests/test_kernels.py:15 of
the reference): the merge only reorders fp32 sums.  The CUDA kernels
themselves are held against ``attention_ref`` on the card by chip_smoke.py
(phase 3), on the shapes of ``chip_smoke.flash_cases``.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jax_flash_attention
from repro.models.attention import dense_attention
from repro_torch.kernels.flash_attention.ops import (DECODE_BLOCK_ROWS,
                                                     HEAD_DIMS, KV_TILE,
                                                     MIN_BLOCKS, R_MAX,
                                                     TC_HEAD_DIMS,
                                                     WARP_BLOCK_ROWS,
                                                     WARP_MIN_BLOCKS, plan)
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     decode_tiles,
                                                     split_decode_ref)

TOL = 2e-5
ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP_SMOKE = _chip_smoke()
CASES = CHIP_SMOKE.flash_cases()


def _rolling_kpos(pos: int, L: int) -> torch.Tensor:
    """Positions in a rolling buffer of L slots once ``pos`` is written
    (position p in slot p % L, -1 where nothing was written yet)."""
    p = pos - (pos - np.arange(L)) % L
    return torch.from_numpy(np.where(p >= 0, p, -1).astype(np.int32))


def _admitted(Sq, Skv, *, q_offset=0, kv_len=None, causal=True, window=0,
              chunk=0, k_pos=None) -> np.ndarray:
    """Slots some query may see, by the reference's mask rule written out
    (repro/models/attention.py:_mask with the kernels' kv_len)."""
    kv_len = Skv if kv_len is None else kv_len
    qp = q_offset + np.arange(Sq)[:, None]
    slot = np.arange(Skv)[None, :]
    kp = slot if k_pos is None else k_pos.numpy().astype(np.int64)[None, :]
    ok = (slot < kv_len) & (kp >= 0) & (qp >= 0)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= kp > qp - window
    if chunk:
        ok &= kp // chunk == qp // chunk
    return np.flatnonzero(ok.any(0))


# ---- which kernel ----

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,shape,kw", CASES, ids=[c[0] for c in CASES])
def test_plan_picks_the_kernel_for_each_phase3_case(name, shape, kw, dtype):
    """At most 8 query rows: warp decode for at most R_MAX of them per kv
    head, else split decode, every dtype and head_dim; else bf16 at
    head_dim 64-256 without key positions: the tensor-core prefill; else
    the SIMT kernel."""
    B, Sq, Skv, Hq, Hkv, D = shape
    how = plan(B, Sq, Hq, Hkv, D, dtype, kw.get("kv_len", Skv),
               "k_pos" in kw)
    if Sq <= 8:
        want = ("warp_decode" if Hq // Hkv * Sq <= R_MAX
                else "split_decode")
    elif dtype == torch.bfloat16 and D in TC_HEAD_DIMS and "k_pos" not in kw:
        want = "tc_prefill"
    else:
        want = "simt"
    assert how.impl == want
    if name in CHIP_SMOKE.FLASH_TIMED[dtype]:
        assert how.impl == CHIP_SMOKE.FLASH_TIMED[dtype][name]


def test_serve_shapes_take_the_redesigned_kernels():
    """bf16 prefill of chatglm3-6b (D 128) and recurrentgemma-2b (D 256)
    on the tensor cores, both decodes split; fp32 prefill on the SIMT
    kernel."""
    shapes = {name: (shape, kw) for name, shape, kw in CASES}
    for name, impl in (("prefill", "tc_prefill"),
                       ("prefill_d256_window", "tc_prefill"),
                       ("decode", "split_decode"),
                       ("decode_d256_rolling", "split_decode")):
        (B, Sq, Skv, Hq, Hkv, D), kw = shapes[name]
        kv_len = kw.get("kv_len", Skv)
        assert plan(B, Sq, Hq, Hkv, D, torch.bfloat16, kv_len,
                    "k_pos" in kw).impl == impl
    (B, Sq, _, Hq, Hkv, D), _ = shapes["prefill"]
    assert plan(B, Sq, Hq, Hkv, D, torch.float32, Sq).impl == "simt"


@pytest.mark.parametrize("dtype,Sq,k_pos,impl", [
    (torch.bfloat16, 2048, False, "tc_prefill"),   # phi-3-vision prefill
    (torch.bfloat16, 9, False, "tc_prefill"),
    (torch.bfloat16, 24, True, "simt"),            # key positions
    (torch.float32, 2048, False, "simt"),
    (torch.bfloat16, 1, False, "warp_decode"),     # phi-3-vision decode
    (torch.float32, 1, False, "warp_decode"),
    (torch.bfloat16, 8, True, "warp_decode"),
])
def test_plan_at_head_dim_96(dtype, Sq, k_pos, impl):
    """phi-3-vision-4.2b's head_dim (MHA) reaches the prefill kernels and
    the warp decode kernel."""
    assert 96 in HEAD_DIMS and 96 in TC_HEAD_DIMS
    assert plan(8, Sq, 32, 32, 96, dtype, 2080, k_pos).impl == impl


@pytest.mark.parametrize("D", [8, 48, 80, 112, 160, 512])
@pytest.mark.parametrize("Sq", [1, 2048])
def test_plan_raises_for_head_dims_without_a_kernel(D, Sq):
    """No fallback: a head_dim no kernel takes raises, decode and prefill,
    whatever the dtype."""
    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="head_dim"):
            plan(2, Sq, 4, 4, D, dtype, 2048)


# ---- how split decode cuts the keys ----

@pytest.mark.parametrize("B,Sq,Hq,Hkv,kv_len", [
    (8, 1, 32, 2, 1041),      # chatglm3-6b decode
    (8, 1, 32, 2, 1056),      # ... over the whole buffer
    (8, 1, 10, 1, 4096),      # recurrentgemma-2b rolling decode
    (8, 1, 64, 8, 997),       # splits of 3 tiles
    (1, 1, 16, 1, 40000),     # one kv head, a long cache
    (2, 4, 8, 2, 300),
    (1, 8, 8, 2, 256),        # two row groups
    (3, 1, 4, 4, 1),
    (1, 1, 2, 1, 0),          # nothing written
])
def test_decode_splits_cover_each_slot_once(B, Sq, Hq, Hkv, kv_len):
    how = plan(B, Sq, Hq, Hkv, 128, torch.bfloat16, kv_len)
    warp = Hq // Hkv * Sq <= R_MAX
    assert how.impl == ("warp_decode" if warp else "split_decode")
    assert how.splits >= 1
    n_tiles = -(-kv_len // KV_TILE)
    slots = []
    for s in range(how.splits):
        t0 = s * how.tiles_per_split
        t1 = min(t0 + how.tiles_per_split, n_tiles)
        assert t0 < t1 or n_tiles == 0       # no split past the last tile
        for t in range(t0, t1):              # whole 64-key tiles
            slots += range(t * KV_TILE, min((t + 1) * KV_TILE, kv_len))
    assert slots == list(range(kv_len))
    groups = -(-(Hq // Hkv) * Sq // (WARP_BLOCK_ROWS if warp
                                     else DECODE_BLOCK_ROWS))
    assert how.blocks == B * Hkv * groups * how.splits
    base = B * Hkv * groups
    if warp and n_tiles:       # tiles dealt evenly over enough splits
        want = min(n_tiles, -(-WARP_MIN_BLOCKS // base))
        assert how.tiles_per_split == -(-n_tiles // want)
    elif n_tiles * base >= MIN_BLOCKS:   # enough tiles to fill it
        assert how.blocks >= MIN_BLOCKS


def test_decode_serve_shapes_fill_the_card():
    """>= 2 x 132 blocks at both serve shapes, as designed: chatglm3-6b 17
    splits of one tile (272 blocks), recurrentgemma-2b 64 (512)."""
    glm = plan(8, 1, 32, 2, 128, torch.bfloat16, 1041)
    rg = plan(8, 1, 10, 1, 256, torch.bfloat16, 4096, True)
    assert (glm.splits, glm.tiles_per_split, glm.blocks) == (17, 1, 272)
    assert (rg.splits, rg.tiles_per_split, rg.blocks) == (64, 1, 512)
    assert min(glm.blocks, rg.blocks) >= 264


def test_decode_mha_split_kernel_forced_keeps_its_plan():
    """The split kernel, forced on phi-3-vision-4.2b's decode (MHA, G 1),
    keeps the plan it ran before the warp kernel: one block per (split,
    head, batch) with 1 of its 16 rows used; 3 splits of 16 tiles over 2049
    slots, 768 blocks (what chip_smoke.py times beside the warp kernel)."""
    how = plan(8, 1, 32, 32, 96, torch.bfloat16, 2049, impl="split_decode")
    assert (how.splits, how.tiles_per_split, how.blocks) == (3, 16, 768)


# ---- which tiles are read ----

@pytest.mark.parametrize("name,Sq,L,kw", [
    ("wrapped_serve", 1, 4096, dict(q_offset=4112, window=2048)),
    ("partial_serve", 1, 4096, dict(q_offset=1000, window=2048)),
    ("wrapped_twice", 1, 256, dict(q_offset=700, window=100)),
    ("partial_small", 1, 16, dict(q_offset=5, window=8)),
    ("several_queries", 4, 512, dict(q_offset=900, window=300)),
    ("chunked", 2, 512, dict(q_offset=1200, chunk=128)),
])
def test_kpos_skipping_keeps_every_admitted_key(name, Sq, L, kw):
    k_pos = _rolling_kpos(kw["q_offset"] + Sq - 1, L)
    how = plan(8, Sq, 10, 1, 256, torch.bfloat16, L, True)
    read = set()
    for s in range(how.splits):
        read |= set(decode_tiles(s * how.tiles_per_split,
                                 (s + 1) * how.tiles_per_split, Sq=Sq,
                                 kv_len=L, k_pos=k_pos, **kw))
    admitted = _admitted(Sq, L, k_pos=k_pos, **kw)
    assert len(admitted) and set(admitted // KV_TILE) <= read
    window = kw.get("window") or L
    # only the tiles that hold the window's positions (+1 for a cut one),
    # the rest skipped before their K/V are read
    assert len(read) <= -(-(window + Sq - 1) // KV_TILE) + 1
    if name == "wrapped_serve":              # 2048 of the 4096 slots
        assert len(read) == 33 and how.splits == 64


@pytest.mark.parametrize("kw", [dict(q_offset=1040, kv_len=1041),
                                dict(q_offset=1040),
                                dict(q_offset=1040, window=100),
                                dict(q_offset=1040, chunk=256),
                                dict(q_offset=10, causal=False)])
def test_slot_bounds_keep_every_admitted_key(kw):
    """Without key positions the tiles come from the bounds of the query
    positions alone."""
    Skv = 1056
    read = decode_tiles(0, 10 ** 6, Sq=1, kv_len=kw.get("kv_len", Skv),
                        **{a: b for a, b in kw.items() if a != "kv_len"})
    admitted = _admitted(1, Skv, **kw)
    assert set(admitted // KV_TILE) <= set(read)
    assert set(read) == set(range(admitted[0] // KV_TILE,
                                  admitted[-1] // KV_TILE + 1))


# ---- split then merge ----

def _pair(a: np.ndarray):
    return jnp.asarray(a, jnp.float32), torch.from_numpy(
        np.asarray(a, np.float32))


@pytest.mark.parametrize("B,Hq,Hkv,D,Skv,pos,kv_len,window", [
    (2, 16, 1, 32, 200, 199, None, 0),    # G 16, one tile a split
    (1, 10, 1, 256, 150, 149, None, 0),   # G 10 at recurrentgemma's D
    (2, 16, 2, 32, 300, 230, 231, 0),     # kv_len below the buffer
    (2, 10, 1, 32, 300, 299, None, 100),  # window
    (4, 32, 16, 32, 700, 699, None, 0),   # 64 blocks a split: splits of 2
                                          # tiles, the last one of 1
    (2, 8, 8, 96, 700, 650, 651, 0),      # D 96, MHA (G 1)
    (2, 4, 4, 96, 300, 299, None, 100),   # D 96, G 1, window
    (1, 8, 2, 96, 400, 399, None, 0),     # D 96, G 4
])
def test_split_decode_matches_pallas(B, Hq, Hkv, D, Skv, pos, kv_len, window):
    """One query at ``pos`` over a cache; the Pallas kernel sees only the
    written slots (it has no kv_len), the port the whole buffer."""
    rng = np.random.default_rng(21)
    n = Skv if kv_len is None else kv_len
    qj, qt = _pair(rng.normal(size=(B, 1, Hq, D)))
    kj, kt = _pair(rng.normal(size=(B, Skv, Hkv, D)))
    vj, vt = _pair(rng.normal(size=(B, Skv, Hkv, D)))
    how = plan(B, 1, Hq, Hkv, D, torch.float32, n, impl="split_decode")
    assert how.splits > 1
    out = split_decode_ref(qt, kt, vt, splits=how.splits,
                           tiles_per_split=how.tiles_per_split, q_offset=pos,
                           kv_len=kv_len, window=window)
    ref = jax_flash_attention(qj, kj[:, :n], vj[:, :n], q_offset=pos,
                              window=window, block_q=8, block_kv=128,
                              interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("B,pos,L,window,D", [
    (2, 700, 256, 100, 32),     # wrapped twice: skipped tiles between
    (2, 100, 256, 100, 32),     # partly written: slots 101.. at -1
    (2, 300, 200, 64, 256),     # D 256, window cut inside a tile
    (8, 5000, 4352, 2048, 32),  # splits of 2 tiles, some skipped whole
])
def test_split_decode_with_k_pos_matches_model_attention(B, pos, L, window,
                                                         D):
    """recurrentgemma-2b's rolling buffer (G 10) against the reference's
    dense attention with the same positions."""
    rng = np.random.default_rng(22)
    Hq, Hkv = 10, 1
    kpos = _rolling_kpos(pos, L)
    qj, qt = _pair(rng.normal(size=(B, 1, Hq, D)))
    kj, kt = _pair(rng.normal(size=(B, L, Hkv, D)))
    vj, vt = _pair(rng.normal(size=(B, L, Hkv, D)))
    how = plan(B, 1, Hq, Hkv, D, torch.float32, L, True)
    out = split_decode_ref(qt, kt, vt, splits=how.splits,
                           tiles_per_split=how.tiles_per_split, q_offset=pos,
                           window=window, k_pos=kpos)
    ref = dense_attention(qj, kj, vj, jnp.asarray([pos]),
                          jnp.asarray(kpos.numpy()), window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("Sq,kw", [
    (4, dict(q_offset=296, kv_len=300)),
    (8, dict(q_offset=248)),
    (3, dict(q_offset=150, kv_len=153, chunk=64)),
    (1, dict(causal=False, q_offset=5)),
])
def test_split_decode_matches_attention_ref_on_small_cases(Sq, kw):
    """Several queries, chunks and no causal mask: the merge equals one
    softmax over all keys (the plain version the card's checks use)."""
    rng = np.random.default_rng(23)
    B, Skv, Hq, Hkv, D = 2, 300, 8, 2, 16
    q = torch.from_numpy(rng.normal(size=(B, Sq, Hq, D)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32))
    how = plan(B, Sq, Hq, Hkv, D, torch.float32, kw.get("kv_len", Skv),
               impl="split_decode")
    assert how.splits > 1
    out = split_decode_ref(q, k, v, splits=how.splits,
                           tiles_per_split=how.tiles_per_split, **kw)
    torch.testing.assert_close(out, attention_ref(q, k, v, **kw), atol=TOL,
                               rtol=TOL)
