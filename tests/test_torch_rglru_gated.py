"""The RG-LRU's gated entry and its launch plan on the CPU (no card needed).

``rglru_gated`` computes what the reference's ``rglru_mix`` does between
its projections (``src/repro/models/rglru.py:75-89``): the gates, a and b in
fp32, the linear recurrence from an optional state, h in the input dtype and
the fp32 final state.  On a CPU tensor it is the plain version
``rglru_gated_ref``, which is held here against those formulas written in
JAX on the same numpy-seeded inputs (the reference's ``linear_scan_chunked``
for S > 1, its elementwise step for S = 1).  The CUDA kernel is held
against the same plain version on the card by chip_smoke.py (phase 3).

Tolerances:
- fp32 h and every h_last (fp32 on both sides): 1e-4 absolute and relative,
  the reference's own RG-LRU tolerance (2e-5 x 5, tests/test_kernels.py:15
  and :106): the reference scans associatively and in chunks of 256, the
  port sequentially, and exp/sigmoid/softplus come from two libraries; the
  state carries rounding differences for ~1/(1 - a) steps;
- bf16 h: 2e-2 absolute and relative (tests/test_kernels.py:15): both sides
  round the same fp32 states to bf16, so they differ by at most one bf16
  step (2^-8 relative) where the fp32 states straddle a rounding boundary.

The plan (``kernels/rglru_scan/ops.py:plan``) is pure Python: which variant
a call takes and its launch shape at every shape the served model gives it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import recurrentgemma_2b as jax_rg
from repro.models.scan_ops import linear_scan_chunked
from repro_torch.configs import get_config, get_reduced
from repro_torch.kernels.rglru_scan import ops
from repro_torch.kernels.rglru_scan.ops import plan, rglru_gated, rglru_scan

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TOL_STATE = 1e-4
RG = get_config("recurrentgemma-2b")


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


def _inputs(B, S, W, dtype, seed):
    """xa, xi, xc unit normal in ``dtype``; b_a, b_i normal * 0.5 and
    lambda as the model draws it (a^8 uniform in [0.9, 0.999]), fp32; h0
    unit normal fp32.  Each as (JAX array, torch tensor)."""
    rng = np.random.default_rng(seed)
    xs = [_pair(rng.normal(size=(B, S, W)), dtype) for _ in range(3)]
    u = rng.uniform(0.9, 0.999, W)
    lam = np.log(np.expm1(-np.log(u) / 8.0))
    vecs = [_pair(v, "float32") for v in (rng.normal(size=W) * 0.5,
                                          rng.normal(size=W) * 0.5, lam)]
    return xs + vecs, _pair(rng.normal(size=(B, W)), "float32")


def _jax_gated(xa, xi, xc, b_a, b_i, lam, state):
    """``rglru_mix``'s lines 75-89, from the projections on."""
    B, S, W = xc.shape
    r = jax.nn.sigmoid(xa.astype(jnp.float32) + b_a)
    i = jax.nn.sigmoid(xi.astype(jnp.float32) + b_i)
    log_a_hat = -jax.nn.softplus(lam)
    a = jnp.exp(8.0 * r * log_a_hat)
    b = jnp.sqrt(jnp.maximum(1.0 - a * a, 1e-12)) * i * xc.astype(jnp.float32)
    h0 = state if state is not None else jnp.zeros((B, W), jnp.float32)
    if S == 1:
        h_last = a[:, 0] * h0 + b[:, 0]
        hs = h_last[:, None]
    else:
        hs, h_last = linear_scan_chunked(a, b, h0, chunk=256,
                                         exact=jax_rg.CONFIG.exact_costs)
    return hs.astype(xc.dtype), h_last


def _check(out_t, out_j, tol):
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j, np.float32),
                               atol=tol, rtol=tol)


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors take the plain path: no kernel launch is counted."""
    rglru_gated.launches = rglru_scan.launches = 0
    yield
    assert rglru_gated.launches == rglru_scan.launches == 0


# ---- the plain gated path against the reference's formulas ----

@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,W", [(2, 1, 20), (1, 9, 129), (3, 37, 24),
                                   (2, 300, 16)])
def test_gated_ref_matches_reference_formulas(B, S, W, dtype, with_h0):
    """S = 1 is the decode step; 9 x 129 is ragged; 300 crosses the
    reference's 256-step chunk."""
    args, (h0j, h0t) = _inputs(B, S, W, dtype, seed=S * 1000 + W)
    h, h_last = rglru_gated(*(t for _, t in args),
                            h0t if with_h0 else None)
    hr, hr_last = _jax_gated(*(j for j, _ in args), h0j if with_h0 else None)
    assert h.shape == (B, S, W) and h.dtype == getattr(torch, dtype)
    assert h_last.shape == (B, W) and h_last.dtype == torch.float32
    _check(h, hr, TOL[dtype])
    _check(h_last, hr_last, TOL_STATE)


def test_gated_ref_keeps_the_unrounded_state():
    """h_last is the fp32 state after the last step, not the rounded h, and
    a run split in two (prefill, then decode steps from h_last) gives the
    one run's states."""
    args, _ = _inputs(2, 12, 24, "bfloat16", seed=3)
    xs = [t for _, t in args]
    h, h_last = rglru_gated(*xs)
    assert not torch.equal(h_last, h[:, -1].float())
    torch.testing.assert_close(h_last.to(torch.bfloat16), h[:, -1],
                               atol=0, rtol=0)
    part = [x[:, :8].contiguous() for x in xs[:3]] + xs[3:]
    _, state = rglru_gated(*part)
    for t in range(8, 12):
        step = [x[:, t:t + 1].contiguous() for x in xs[:3]] + xs[3:]
        ht, state = rglru_gated(*step, state)
        torch.testing.assert_close(ht[:, 0], h[:, t], atol=0, rtol=0)
    torch.testing.assert_close(state, h_last, atol=0, rtol=0)


# ---- the plan ----

def _served_shapes():
    """(B, S, W, dtype) of every call the served recurrentgemma-2b gives
    the gated entry in chip_smoke.py: phase 4's bf16 prefill (8 x 4096) and
    decode, phase 5's fp32 ones (8 x 128), the reduced config's (2 x 21
    prompt, 2 x 37 forward) and its decode."""
    W, w = RG.rnn_width, get_reduced("recurrentgemma-2b").rnn_width
    return [(8, 4096, W, torch.bfloat16), (8, 1, W, torch.bfloat16),
            (8, 128, W, torch.float32), (8, 1, W, torch.float32),
            (2, 21, w, torch.float32), (2, 37, w, torch.float32),
            (2, 1, w, torch.float32)]


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("B,S,W,dtype", _served_shapes())
def test_plan_at_served_shapes(B, S, W, dtype, gated):
    """The ring, a block a strip of a batch row, C x G threads, a tile of
    G x L steps with L a kernel instance, within the shared memory; the
    tile covers S with fewer than G x L steps to spare unless S is
    shorter than one thread's steps."""
    how = plan(B, S, W, dtype, gated=gated)
    assert how.variant == "ring"
    assert how.channels in ops.CHANNELS
    assert how.threads == how.channels * how.split <= ops.MAX_THREADS
    assert how.blocks == B * -(-W // how.channels)
    L = how.steps // how.split
    assert how.steps == L * how.split and L in ops.STEPS_PER_THREAD
    tiles = -(-S // how.steps)
    assert tiles * how.steps - S < how.steps or S < L
    assert 2 <= how.stages <= min(ops.MAX_STAGES, max(2, tiles + 1))
    inputs = 3 if gated else 2
    assert how.smem_bytes == (how.stages * inputs * how.steps * how.channels
                              * dtype.itemsize + 8 * how.split
                              * how.channels) <= ops.MAX_SMEM
    assert how.copy_bytes == 16      # every served row is 16-byte aligned


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plan_at_the_serve_prefill_takes_the_sweeps_tiles(dtype):
    """At (8, 4096, 2560) each entry takes its TILES entry unchanged: 320
    or 640 blocks, at least two for each of an H100's 132 SMs."""
    for gated, entry in ((False, "interface"), (True, "gated")):
        C, L, G, P = ops.TILES[entry, dtype]
        how = plan(8, 4096, 2560, dtype, gated=gated)
        assert (how.channels, how.steps, how.split, how.stages) == (
            C, L * G, G, P)
        assert how.blocks == 8 * 2560 // C >= 2 * 132
        assert how.copy_bytes == 16


def test_plan_at_a_decode_step_takes_one_thread_a_channel():
    for dtype in (torch.bfloat16, torch.float32):
        how = plan(8, 1, 2560, dtype, gated=True)
        assert (how.steps, how.split, how.stages) == (8, 1, 2)


@pytest.mark.parametrize("W,dtype,align,want", [
    (2560, torch.bfloat16, 16, 16), (20, torch.float32, 16, 16),
    (20, torch.bfloat16, 16, 8), (129, torch.float32, 16, 4),
    (129, torch.bfloat16, 16, 2), (2560, torch.float32, 4, 4),
    (2560, torch.bfloat16, 8, 8)])
def test_plan_copy_width_follows_rows_and_addresses(W, dtype, align, want):
    """16-byte copies where a row (W elements) and every address allow,
    else 8 or 4; bf16 rows of odd W take 2 (through registers)."""
    assert plan(2, 50, W, dtype, align=align).copy_bytes == want


def test_plan_forcing_a_variant():
    how = plan(8, 4096, 2560, torch.float32, "simple")
    assert how == ops.Plan("simple", 64, 8 * 40)
    assert plan(8, 4096, 2560, torch.float32, "ring").variant == "ring"
    assert ops.variants() == ("ring", "simple")
    assert ops.variants(gated=True) == ("ring",)


def test_plan_forcing_a_tile():
    how = plan(8, 4096, 2560, torch.bfloat16, gated=True, tile=(64, 64, 3, 4))
    assert (how.channels, how.steps, how.stages, how.split) == (64, 64, 3, 4)
    assert how.threads == 256 and how.blocks == 320


@pytest.mark.parametrize("kwargs,match", [
    (dict(variant="warp"), "unknown variant"),
    (dict(variant="simple", gated=True), "cannot take"),
    (dict(variant="simple", tile=(64, 32, 2, 2)), "takes no tile"),
    (dict(tile=(128, 32, 2, 2)), "beyond the kernel's limits"),
    (dict(tile=(64, 96, 2, 4)), "beyond the kernel's limits"),
    (dict(tile=(64, 32, 1, 2)), "beyond the kernel's limits"),
    (dict(tile=(64, 32, 5, 2)), "beyond the kernel's limits"),
    (dict(tile=(64, 128, 2, 16)), "beyond the kernel's limits"),
    (dict(tile=(64, 128, 4, 8), gated=True), "beyond the kernel's limits"),
])
def test_plan_refuses_what_the_kernel_cannot_take(kwargs, match):
    with pytest.raises(ValueError, match=match):
        plan(8, 4096, 2560, torch.float32, **kwargs)


@pytest.mark.parametrize("kwargs,every", [
    (dict(), 12),                        # not a multiple of 8 steps a thread
    (dict(), 4),
    (dict(), 48),                        # not a power of two
    (dict(tile=(64, 32, 2, 2)), 8),      # 16 steps a thread
    (dict(tile=(64, 32, 2, 2)), -16),
])
def test_plan_refuses_states_off_the_threads_steps(kwargs, every):
    """The forward keeps a state where a thread's steps start: the
    backward's chunk must be a power of two and a multiple of the tile's
    steps a thread."""
    with pytest.raises(ValueError, match="states every"):
        plan(8, 4096, 2560, torch.bfloat16, gated=True, states=every,
             **kwargs)


@pytest.mark.parametrize("every", (ops.BWD_STEPS, ops.BWD_STEPS // 2))
def test_plan_takes_the_backwards_chunks(every):
    """The backward's chunk, and half of it (the forward keeps states at
    any power of two its threads' steps divide), at every served shape's
    tile (8 steps a thread), and the sweep's 16; only the gated entry keeps
    states."""
    for B, S, W, dtype in _served_shapes():
        assert plan(B, S, W, dtype, gated=True, states=every).variant == \
            "ring"
    plan(8, 4096, 2560, torch.bfloat16, gated=True, tile=(64, 32, 2, 2),
         states=every)
    with pytest.raises(ValueError, match="only the gated entry"):
        plan(8, 4096, 2560, torch.bfloat16, states=every)


def test_expected_launches_count_the_gated_entry_per_call():
    """chip_smoke.py's phase-4 count: one gated launch per RG-LRU layer in
    the prefill and in each of the 31 decode steps (18 x 32 = 576), none
    of the interface entry; none for the other served models."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for arch, _, _, new in cs.SERVES:
        want = get_config(arch).layer_kinds().count("rglru") * new
        got = cs.expected_launches(get_config(arch), new)
        assert got["rglru_gated"] == want and got["rglru_scan"] == 0
    assert cs.expected_launches(RG, 32)["rglru_gated"] == 576
    small = dataclasses.replace(RG, n_layers=3, param_dtype="float32")
    assert cs.expected_launches(small, 8)["rglru_gated"] == 16


# ---- what the wrappers refuse, on every device ----

def _gated_args(B=2, S=5, W=24):
    return ([torch.randn(B, S, W) for _ in range(3)]
            + [torch.randn(W) for _ in range(3)] + [torch.randn(B, W)])


def test_wrappers_reject_other_devices():
    x = torch.empty(1, 4, 8, device="meta")
    v = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rglru_scan(x, x)
    with pytest.raises(ValueError, match="unsupported device"):
        rglru_gated(x, x, x, v, v, v)


def test_wrappers_reject_non_contiguous_inputs():
    a = torch.randn(2, 24, 5).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        rglru_scan(a, torch.randn(2, 5, 24))
    args = _gated_args()
    args[2] = a
    with pytest.raises(ValueError, match="contiguous"):
        rglru_gated(*args)
    args = _gated_args()
    args[6] = torch.randn(24, 2).t()
    with pytest.raises(ValueError, match="contiguous"):
        rglru_gated(*args)


@pytest.mark.parametrize("index,bad", [
    (0, torch.randn(2, 6, 24)), (1, torch.randn(2, 5, 23)),
    (3, torch.randn(23)), (4, torch.randn(24, 1)), (5, torch.randn(25)),
    (6, torch.randn(3, 24)), (2, torch.randn(2, 5)),
])
def test_gated_rejects_mismatched_shapes(index, bad):
    args = _gated_args()
    args[index] = bad
    with pytest.raises(ValueError):
        rglru_gated(*args)


def test_wrappers_reject_mismatched_shapes_and_dtypes():
    with pytest.raises(ValueError, match="b"):
        rglru_scan(torch.randn(2, 5, 24), torch.randn(2, 5, 25))
    with pytest.raises(ValueError, match="B, S, W"):
        rglru_scan(torch.randn(5, 24), torch.randn(5, 24))
    with pytest.raises(TypeError, match="b is"):
        rglru_scan(torch.randn(2, 5, 24), torch.randn(2, 5, 24).double())
    args = _gated_args()
    args[0] = args[0].to(torch.bfloat16)
    with pytest.raises(TypeError, match="xa is"):
        rglru_gated(*args)
    args = _gated_args()
    args[3] = args[3].to(torch.bfloat16)
    with pytest.raises(TypeError, match="b_a is"):
        rglru_gated(*args)
    with pytest.raises(TypeError, match="not supported"):
        rglru_scan(torch.randn(2, 5, 24).half(), torch.randn(2, 5, 24).half())


def test_wrappers_check_the_variant_and_tile_on_the_cpu():
    a = torch.randn(2, 5, 24)
    with pytest.raises(ValueError, match="unknown variant"):
        rglru_scan(a, a, variant="warp")
    with pytest.raises(ValueError, match="beyond"):
        rglru_gated(*_gated_args(), tile=(128, 32, 2, 2))
    torch.testing.assert_close(rglru_scan(a, a, variant="simple"),
                               rglru_scan(a, a), atol=0, rtol=0)
