"""The warp decode kernel's plan and arithmetic, on the CPU (no card
needed): which decode calls ``ops.plan`` sends to ``warp_decode``, how it
cuts the keys, and the kernel's per-warp online softmax, merged in the
block and then over the splits, in plain PyTorch (``ref.warp_decode_ref``)
against the reference's Pallas kernel in interpret mode and its dense
attention.

Tolerance: fp32 2e-5, absolute and relative (tests/test_kernels.py:15 of
the reference): the warps and splits only reorder fp32 sums.  The CUDA
kernel itself is held against ``attention_ref`` on the card by
chip_smoke.py (phase 3, every decode case on both decode kernels).
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jax_flash_attention
from repro.models.attention import dense_attention
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention.ops import (KV_TILE, R_MAX,
                                                     WARP_BLOCK_ROWS,
                                                     WARP_MIN_BLOCKS, Plan,
                                                     plan,
                                                     warp_decode_layout)
from repro_torch.kernels.flash_attention.ref import warp_decode_ref

TOL = 2e-5
ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pair(a: np.ndarray):
    return jnp.asarray(a, jnp.float32), torch.from_numpy(
        np.asarray(a, np.float32))


def _rolling_kpos(pos: int, L: int) -> torch.Tensor:
    """Positions in a rolling buffer of L slots once ``pos`` is written
    (position p in slot p % L, -1 where nothing was written yet)."""
    p = pos - (pos - np.arange(L)) % L
    return torch.from_numpy(np.where(p >= 0, p, -1).astype(np.int32))


def _warp_ref(q, k, v, how: Plan, **kw):
    B, Sq, Hq, D = q.shape
    warps, step = warp_decode_layout(Hq // k.shape[2] * Sq, D, q.dtype)
    return warp_decode_ref(q, k, v, splits=how.splits,
                           tiles_per_split=how.tiles_per_split, warps=warps,
                           step=step, **kw)


# ---- which decode kernel ----

@pytest.mark.parametrize("Hq,Hkv,Sq", [
    (32, 32, 1), (8, 4, 1), (16, 4, 1), (28, 4, 1), (8, 1, 1), (4, 4, 8),
    (8, 2, 2), (9, 1, 1), (10, 1, 1), (32, 2, 1), (4, 4, 3), (8, 4, 8)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plan_routes_decode_by_rows_per_kv_head(Hq, Hkv, Sq, dtype):
    """G * Sq <= R_MAX goes to the warp kernel, more to the split kernel,
    whatever the dtype, head_dim and key positions."""
    rows = Hq // Hkv * Sq
    want = "warp_decode" if rows <= R_MAX else "split_decode"
    for D in (16, 96, 256):
        for k_pos in (False, True):
            assert plan(8, Sq, Hq, Hkv, D, dtype, 2049, k_pos).impl == want


def test_r_max_boundary():
    """R_MAX rows a kv head still take the warp kernel, R_MAX + 1 the
    split kernel; a block holds all of them (one row group)."""
    assert R_MAX <= WARP_BLOCK_ROWS
    at = plan(2, 1, R_MAX, 1, 128, torch.bfloat16, 500)
    above = plan(2, 1, R_MAX + 1, 1, 128, torch.bfloat16, 500)
    assert (at.impl, above.impl) == ("warp_decode", "split_decode")
    assert at.blocks == 2 * at.splits


def test_decode_mha_takes_the_warp_kernel():
    """phi-3-vision-4.2b's decode (MHA, G 1, 2049 of 2080 slots): one block
    per (head, batch), 256 blocks, enough for one split of all 33 tiles,
    so the kernel writes the output itself and no merge runs."""
    how = plan(8, 1, 32, 32, 96, torch.bfloat16, 2049)
    assert how == Plan("warp_decode", 1, 33, 256)
    assert WARP_MIN_BLOCKS <= 256


def test_decode_serve_plans_of_gqa_models_unchanged():
    """chatglm3-6b (G 16) and recurrentgemma-2b (G 10, key positions) keep
    the split kernel with their plans."""
    assert plan(8, 1, 32, 2, 128, torch.bfloat16, 1041) == Plan(
        "split_decode", 17, 1, 272)
    assert plan(8, 1, 10, 1, 256, torch.bfloat16, 4096, True) == Plan(
        "split_decode", 64, 1, 512)


def test_forced_decode_kernel():
    """``impl`` forces either decode kernel (and ``splits`` its split
    count); it raises for a prefill, or for a kernel that is not a decode
    kernel."""
    assert plan(8, 1, 32, 2, 128, torch.bfloat16, 1041,
                impl="warp_decode").impl == "warp_decode"
    assert plan(8, 1, 32, 32, 96, torch.bfloat16, 2049,
                impl="split_decode") == Plan("split_decode", 3, 16, 768)
    assert plan(8, 1, 32, 32, 96, torch.bfloat16, 2049, splits=3) == Plan(
        "warp_decode", 3, 11, 768)
    with pytest.raises(ValueError, match="impl"):
        plan(8, 9, 32, 32, 96, torch.bfloat16, 2049, impl="warp_decode")
    with pytest.raises(ValueError, match="impl"):
        plan(8, 1, 32, 32, 96, torch.bfloat16, 2049, impl="tc_prefill")


@pytest.mark.parametrize("B,Sq,Hq,Hkv,kv_len,splits", [
    (8, 1, 32, 32, 2049, None),   # phi-3-vision decode: one split
    (1, 1, 4, 4, 4000, None),     # a long cache on few blocks: 63 splits
    (2, 1, 32, 32, 2049, None),   # 64 blocks: 4 splits of 9, 9, 9, 6
    (2, 1, 8, 1, 997, None),      # G 8
    (8, 1, 28, 4, 1041, None),    # qwen2-7b's heads (G 7)
    (2, 8, 4, 4, 300, None),      # 8 queries a head
    (3, 1, 4, 4, 1, None),
    (1, 1, 2, 1, 0, None),        # nothing written
    (8, 1, 32, 32, 2049, 2),
    (8, 1, 32, 32, 2049, 4),
    (8, 1, 32, 2, 1041, 3),       # forced on G 16: two row groups
    (8, 1, 28, 4, 1041, 100),     # more splits forced than tiles
])
def test_warp_decode_splits_cover_each_slot_once(B, Sq, Hq, Hkv, kv_len,
                                                 splits):
    how = plan(B, Sq, Hq, Hkv, 96, torch.bfloat16, kv_len,
               impl="warp_decode", splits=splits)
    n_tiles = -(-kv_len // KV_TILE)
    slots = []
    for s in range(how.splits):
        t0 = s * how.tiles_per_split
        t1 = min(t0 + how.tiles_per_split, n_tiles)
        assert t0 < t1 or n_tiles == 0       # no split past the last tile
        for t in range(t0, t1):
            slots += range(t * KV_TILE, min((t + 1) * KV_TILE, kv_len))
    assert slots == list(range(kv_len))
    groups = -(-(Hq // Hkv) * Sq // WARP_BLOCK_ROWS)
    assert how.blocks == B * Hkv * groups * how.splits
    # the tiles dealt evenly: every split but the last has tiles_per_split,
    # the last at least one; as many splits as the grid needs to reach
    # WARP_MIN_BLOCKS (one if it already does), or as forced
    want = splits or -(-WARP_MIN_BLOCKS // (B * Hkv * groups))
    if n_tiles:
        assert how.tiles_per_split == -(-n_tiles // min(want, n_tiles))
        assert how.splits <= want
    if splits is None and B * Hkv * groups >= WARP_MIN_BLOCKS:
        assert how.splits == 1                # a full grid: no merge


def test_warp_slices_cover_each_tile_once():
    """The warps' key slices, ``step`` keys at a time, cover a tile's 64
    keys once, at every head_dim, dtype and row cap."""
    for rows in (1, 2, 3, 8):
        for D in (16, 32, 64, 96, 128, 256):
            for dt in (torch.bfloat16, torch.float32):
                warps, step = warp_decode_layout(rows, D, dt)
                kw = KV_TILE // warps
                assert kw * warps == KV_TILE and kw % step == 0
                keys = [w * kw + j + i for w in range(warps)
                        for j in range(0, kw, step) for i in range(step)]
                assert sorted(keys) == list(range(KV_TILE))


@pytest.mark.parametrize("arch,batch,prompt,new", _chip_smoke().SERVES)
def test_expected_flash_impls_follow_the_plan(arch, batch, prompt, new):
    """``chip_smoke.expected_flash_impls`` (phase 4's exact counts) agrees
    with ``plan`` for each served model: phi-3-vision-4.2b's 992,
    qwen2-7b's 868, stablelm-1.6b's 744 and whisper-small's 744 (self and
    cross) decode launches on the warp kernel, chatglm3-6b's,
    recurrentgemma-2b's and starcoder2-3b's on the split kernel,
    falcon-mamba-7b none; whisper's prefill runs its 12 encoder layers, 12
    self and 12 cross attentions on the tensor cores; the MoE models at
    their served depth (``chip_smoke.serve_config``): dbrx-132b's 8 layers
    at G 6 and llama4's 4 at G 5 on the warp kernel."""
    cs = _chip_smoke()
    cfg = cs.serve_config(arch)[0]
    got = cs.expected_flash_impls(cfg, new)
    attn = sum(k.startswith("attn") for k in cfg.layer_kinds())
    calls = 2 * attn if cfg.is_encdec else attn    # a position's calls
    enc = cfg.n_enc_layers if cfg.is_encdec else 0
    impl = plan(batch, 1, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                torch.bfloat16, cfg.img_tokens + prompt + 1).impl if attn \
        else None
    want = {"phi-3-vision-4.2b": ("warp_decode", 992, 32),
            "chatglm3-6b": ("split_decode", 868, 28),
            "recurrentgemma-2b": ("split_decode", 248, 8),
            "falcon-mamba-7b": (None, 0, 0),
            "qwen2-7b": ("warp_decode", 868, 28),
            "stablelm-1.6b": ("warp_decode", 744, 24),
            "starcoder2-3b": ("split_decode", 930, 30),
            "whisper-small": ("warp_decode", 744, 36),
            "dbrx-132b": ("warp_decode", 248, 8),
            "llama4-maverick-400b-a17b": ("warp_decode", 124, 4)}[arch]
    assert (impl, calls * (new - 1), enc + calls) == want
    assert sum(got.values()) == enc + calls * new
    assert got["tc_prefill"] == want[2]
    if impl:
        assert got[impl] == want[1]
        other = ({"split_decode", "warp_decode"} - {impl}).pop()
        assert got[other] == 0


@pytest.mark.parametrize("arch,kv_lens,want", [
    # MHA at D 64: 8 x 32 kv heads is already WARP_MIN_BLOCKS, one split
    ("stablelm-1.6b", range(1025, 1056),
     Plan("warp_decode", splits=1, tiles_per_split=17, blocks=256)),
    # G 12 > R_MAX: the split kernel, 16-row blocks (4 rows idle), 17
    # one-tile splits of 16 blocks
    ("starcoder2-3b", range(1025, 1056),
     Plan("split_decode", splits=17, tiles_per_split=1, blocks=272)),
    # whisper's self-attention over 417-447 keys and its cross attention
    # over the 1500 encoder states: 96 blocks a split, so 3 splits
    ("whisper-small", range(417, 448),
     Plan("warp_decode", splits=3, tiles_per_split=3, blocks=288)),
    ("whisper-small", (1500,),
     Plan("warp_decode", splits=3, tiles_per_split=8, blocks=288)),
])
def test_decode_plans_are_pinned(arch, kv_lens, want):
    """The decode plans of phase 4's LayerNorm models (8 sequences), in
    bf16 and fp32, at every step of a 32-token generate."""
    cfg = get_config(arch)
    for kv_len in kv_lens:
        for dtype in (torch.bfloat16, torch.float32):
            assert plan(8, 1, cfg.n_heads, cfg.n_kv_heads,
                        cfg.resolved_head_dim, dtype, kv_len) == want, kv_len


def test_qwen2_decode_plan_is_pinned():
    """qwen2-7b's 31 decode steps (8 sequences, 4 kv heads of 7 query
    heads, head_dim 128, 1025-1055 keys): the warp kernel, 17 tiles dealt
    into 6 splits of 3 tiles (32 blocks a split, under WARP_MIN_BLOCKS),
    192 blocks, in bf16 and fp32."""
    cfg = get_config("qwen2-7b")
    for kv_len in range(1025, 1056):
        for dtype in (torch.bfloat16, torch.float32):
            how = plan(8, 1, cfg.n_heads, cfg.n_kv_heads,
                       cfg.resolved_head_dim, dtype, kv_len)
            assert how == Plan("warp_decode", splits=6, tiles_per_split=3,
                               blocks=192), kv_len
    assert warp_decode_layout(7, 128, torch.bfloat16)[0] == 4


# ---- the warp kernel's arithmetic ----

@pytest.mark.parametrize("B,Sq,Hq,Hkv,D,Skv,pos,kw,splits", [
    (2, 1, 4, 4, 96, 300, 299, {}, None),              # G 1, D 96
    (2, 1, 4, 4, 64, 300, 299, {}, None),              # G 1, D 64
    (2, 1, 4, 4, 96, 700, 650, dict(kv_len=651), 1),   # one split
    (1, 1, 4, 4, 96, 700, 650, dict(kv_len=651), 4),   # several
    (2, 1, 4, 2, 32, 300, 299, {}, None),              # G 2
    (2, 1, 8, 2, 32, 300, 230, dict(kv_len=231), None),  # G 4, kv_len
    (1, 1, 14, 2, 32, 300, 299, {}, 2),                # G 7
    (1, 2, 2, 2, 96, 300, 298, {}, None),              # Sq 2..8, G 1
    (1, 5, 2, 2, 32, 300, 295, {}, None),
    (1, 8, 2, 2, 96, 300, 292, {}, 3),
    (2, 1, 4, 4, 96, 300, 299, dict(window=100), None),  # window
    (2, 1, 4, 4, 32, 500, 450, dict(chunk=128), None),   # chunk
    (1, 3, 4, 2, 16, 200, 150, dict(kv_len=153, chunk=64), None),
])
def test_warp_decode_matches_pallas(B, Sq, Hq, Hkv, D, Skv, pos, kw,
                                    splits):
    """Queries at pos .. pos + Sq - 1 over a cache; the Pallas kernel sees
    only the written slots (it has no kv_len), the port the whole buffer."""
    rng = np.random.default_rng(31)
    kw = dict(kw)
    kv_len = kw.pop("kv_len", None)
    n = Skv if kv_len is None else kv_len
    qj, qt = _pair(rng.normal(size=(B, Sq, Hq, D)))
    kj, kt = _pair(rng.normal(size=(B, Skv, Hkv, D)))
    vj, vt = _pair(rng.normal(size=(B, Skv, Hkv, D)))
    how = plan(B, Sq, Hq, Hkv, D, torch.float32, n, splits=splits)
    assert how.impl == "warp_decode"
    if splits:
        assert how.splits == splits
    out = _warp_ref(qt, kt, vt, how, q_offset=pos, kv_len=kv_len, **kw)
    ref = jax_flash_attention(qj, kj[:, :n], vj[:, :n], q_offset=pos,
                              block_q=8, block_kv=128, interpret=True, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("B,Hq,Hkv,pos,L,window,D", [
    (2, 4, 4, 700, 256, 100, 32),     # G 1, wrapped twice: tiles skipped
    (2, 4, 4, 100, 256, 100, 96),     # partly written: slots 101.. at -1
    (2, 8, 2, 300, 200, 64, 256),     # G 4, D 256, window cut in a tile
    (1, 7, 1, 5000, 4352, 2048, 32),  # G 7, several splits, some skipped
])
def test_warp_decode_with_k_pos_matches_model_attention(B, Hq, Hkv, pos, L,
                                                        window, D):
    """A rolling buffer against the reference's dense attention with the
    same positions."""
    rng = np.random.default_rng(32)
    kpos = _rolling_kpos(pos, L)
    qj, qt = _pair(rng.normal(size=(B, 1, Hq, D)))
    kj, kt = _pair(rng.normal(size=(B, L, Hkv, D)))
    vj, vt = _pair(rng.normal(size=(B, L, Hkv, D)))
    how = plan(B, 1, Hq, Hkv, D, torch.float32, L, True)
    assert how.impl == "warp_decode"
    out = _warp_ref(qt, kt, vt, how, q_offset=pos, window=window, k_pos=kpos)
    ref = dense_attention(qj, kj, vj, jnp.asarray([pos]),
                          jnp.asarray(kpos.numpy()), window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)



@pytest.mark.parametrize("Hq,Hkv,pos,L", [
    (10, 2, 700, 256),     # G 5 (llama4's), wrapped twice
    (12, 2, 300, 256),     # G 6 (dbrx's), wrapped once
    (10, 2, 200, 256),     # partly written: slots 201.. at -1
])
def test_warp_decode_over_a_wrapped_chunk_buffer(Hq, Hkv, pos, L):
    """llama4's chunked decode in small: a rolling buffer of L = chunk
    slots with key positions, the chunk mask, at G 5 and 6 and D 128,
    against the reference's dense attention with the same positions."""
    rng = np.random.default_rng(33)
    kpos = _rolling_kpos(pos, L)
    qj, qt = _pair(rng.normal(size=(2, 1, Hq, 128)))
    kj, kt = _pair(rng.normal(size=(2, L, Hkv, 128)))
    vj, vt = _pair(rng.normal(size=(2, L, Hkv, 128)))
    how = plan(2, 1, Hq, Hkv, 128, torch.float32, L, True)
    assert how.impl == "warp_decode"
    out = _warp_ref(qt, kt, vt, how, q_offset=pos, chunk=L, k_pos=kpos)
    ref = dense_attention(qj, kj, vj, jnp.asarray([pos]),
                          jnp.asarray(kpos.numpy()), chunk=L)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("arch,B,kv_lens,k_pos,want", [
    # 8 sequences x 8 kv heads of 6 query heads: 64 blocks, 17 tiles in
    # 4 splits of 5
    ("dbrx-132b", 8, range(1025, 1056), False,
     Plan("warp_decode", splits=4, tiles_per_split=5, blocks=256)),
    # 2 sequences x 8 kv heads of 5: 16 blocks; the 8192-slot chunk buffer
    # read whole (its key positions mask), 16 splits of 8 tiles
    ("llama4-maverick-400b-a17b", 2, (8192,), True,
     Plan("warp_decode", splits=16, tiles_per_split=8, blocks=256)),
    # the global layer's full cache over 8201-8231 keys
    ("llama4-maverick-400b-a17b", 2, (8201, 8216, 8231), False,
     Plan("warp_decode", splits=15, tiles_per_split=9, blocks=240)),
])
def test_moe_models_decode_plans_are_pinned(arch, B, kv_lens, k_pos, want):
    """The decode plans of phase 4's MoE models in bf16 and fp32."""
    cfg = get_config(arch)
    for kv_len in kv_lens:
        for dtype in (torch.bfloat16, torch.float32):
            assert plan(B, 1, cfg.n_heads, cfg.n_kv_heads,
                        cfg.resolved_head_dim, dtype, kv_len,
                        k_pos) == want, kv_len
