"""The port's scan kernels and the flash kernel's additions (head_dim 256,
key positions) on CPU tensors (their plain PyTorch versions) against the
reference: the Pallas kernels in interpret mode on the shapes of
tests/test_kernels.py, the reference's ``linear_scan`` for the final state,
and its model attention for key positions.  Inputs come from numpy with a
fixed seed and are rounded to the working dtype once, so both sides see
identical values.

Tolerances are the reference's (tests/test_kernels.py:15): fp32 2e-5, bf16
2e-2, absolute and relative; the RG-LRU scan gets 5x, as the reference's own
test does (tests/test_kernels.py:106).  The CUDA kernels are compiled and
held against the same plain versions on the card by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jax_flash_attention
from repro.kernels import mamba_scan as jax_mamba_scan
from repro.kernels import rglru_scan as jax_rglru_scan
from repro.models.attention import dense_attention
from repro.models.scan_ops import linear_scan
from repro_torch.kernels import flash_attention, mamba_scan, rglru_scan

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


def _check(out_t, out_j, tol):
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j, np.float32),
                               atol=tol, rtol=tol)


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors take the plain path: no kernel launch is counted."""
    kernels = (rglru_scan, mamba_scan, flash_attention)
    for k in kernels:
        k.launches = 0
    yield
    assert all(k.launches == 0 for k in kernels)


# ---- rg-lru scan ----

@pytest.mark.parametrize("B,S,W", [(1, 32, 16), (2, 50, 20), (1, 9, 129)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_scan_matches_pallas(B, S, W, dtype):
    rng = np.random.default_rng(7)
    aj, at = _pair(rng.uniform(0.5, 0.99, (B, S, W)), dtype)
    bj, bt = _pair(rng.normal(size=(B, S, W)), dtype)
    h = rglru_scan(at, bt)
    ref = jax_rglru_scan(aj, bj, block_w=8, time_chunk=16, interpret=True)
    assert h.shape == (B, S, W) and h.dtype == at.dtype
    _check(h, ref, TOL[dtype] * 5)


def test_rglru_scan_matches_reference_linear_scan():
    """fp32 (the model path's dtype): every state, and the last one, which
    the model keeps as its decode cache, against the reference's scan."""
    rng = np.random.default_rng(8)
    aj, at = _pair(rng.uniform(0.5, 0.99, (2, 37, 24)), "float32")
    bj, bt = _pair(rng.normal(size=(2, 37, 24)), "float32")
    hs_ref, h_last_ref = linear_scan(aj, bj, jnp.zeros((2, 24), jnp.float32))
    h = rglru_scan(at, bt)
    _check(h, hs_ref, TOL["float32"] * 5)
    _check(h[:, -1], h_last_ref, TOL["float32"] * 5)


# ---- mamba scan ----

def _mamba_inputs(B, S, Di, N, dtype, seed):
    rng = np.random.default_rng(seed)
    return (_pair(rng.uniform(0.5, 0.99, (B, S, Di, N)), dtype),
            _pair(rng.normal(size=(B, S, Di, N)) * 0.1, dtype),
            _pair(rng.normal(size=(B, S, N)), dtype))


@pytest.mark.parametrize("B,S,Di,N", [(1, 32, 16, 4), (2, 40, 24, 8),
                                      (1, 7, 130, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_scan_matches_pallas(B, S, Di, N, dtype):
    (daj, dat), (dbj, dbt), (cj, ct) = _mamba_inputs(B, S, Di, N, dtype, 9)
    y, h_last = mamba_scan(dat, dbt, ct)
    ref = jax_mamba_scan(daj, dbj, cj, block_d=8, time_chunk=16,
                         interpret=True)
    assert y.shape == (B, S, Di) and y.dtype == dat.dtype
    assert h_last.shape == (B, Di, N) and h_last.dtype == torch.float32
    _check(y, ref, TOL[dtype])


@pytest.mark.parametrize("B,S,Di,N", [(1, 32, 16, 4), (2, 40, 24, 8),
                                      (1, 7, 130, 16)])
def test_mamba_scan_final_state_matches_reference(B, S, Di, N):
    """The final state, which the Pallas kernel drops and the model's
    prefill needs, against the reference's ``h_last`` (its model path's
    ``linear_scan``), in fp32 as on the model path."""
    (daj, dat), (dbj, dbt), _ = _mamba_inputs(B, S, Di, N, "float32", 10)
    ct = torch.zeros(B, S, N)
    _, h_last = mamba_scan(dat, dbt, ct)
    _, h_last_ref = linear_scan(daj, dbj, jnp.zeros((B, Di, N), jnp.float32))
    _check(h_last, h_last_ref, TOL["float32"])


# ---- flash attention: head_dim 256 and key positions ----

@pytest.mark.parametrize("mode", [{}, dict(window=16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_d256_matches_pallas(mode, dtype):
    """recurrentgemma-2b's head_dim, MQA, ragged S."""
    rng = np.random.default_rng(11)
    B, S, Hq, Hkv, D = 1, 40, 4, 1, 256
    qj, qt = _pair(rng.normal(size=(B, S, Hq, D)), dtype)
    kj, kt = _pair(rng.normal(size=(B, S, Hkv, D)), dtype)
    vj, vt = _pair(rng.normal(size=(B, S, Hkv, D)), dtype)
    out = flash_attention(qt, kt, vt, **mode)
    ref = jax_flash_attention(qj, kj, vj, block_q=8, block_kv=8,
                              interpret=True, **mode)
    assert out.shape == (B, S, Hq, D)
    _check(out, ref, TOL[dtype])


def _rolling_kpos(pos: int, L: int) -> np.ndarray:
    """Positions in a rolling buffer of L slots once ``pos`` is written
    (position p in slot p % L, -1 where nothing was written yet)."""
    p = pos - (pos - np.arange(L)) % L
    return np.where(p >= 0, p, -1).astype(np.int32)


@pytest.mark.parametrize("pos,D", [(21, 32), (35, 32), (5, 256)])
def test_flash_attention_k_pos_matches_model_attention(pos, D):
    """Decode over a rolling 16-slot buffer with window 8: wrapped once
    (pos 21), twice (pos 35), or partly unwritten (pos 5, slots at -1); the
    same ``q_pos``/``k_pos`` go to the reference's dense attention."""
    rng = np.random.default_rng(12)
    B, L, Hq, Hkv = 2, 16, 4, 1
    kpos = _rolling_kpos(pos, L)
    qj, qt = _pair(rng.normal(size=(B, 1, Hq, D)), "float32")
    kj, kt = _pair(rng.normal(size=(B, L, Hkv, D)), "float32")
    vj, vt = _pair(rng.normal(size=(B, L, Hkv, D)), "float32")
    out = flash_attention(qt, kt, vt, q_offset=pos, window=8,
                          k_pos=torch.from_numpy(kpos))
    ref = dense_attention(qj, kj, vj, jnp.asarray([pos]), jnp.asarray(kpos),
                          window=8)
    _check(out, ref, TOL["float32"])


def test_flash_attention_identity_k_pos_changes_nothing():
    """Key positions equal to the slots give the unpositioned result."""
    rng = np.random.default_rng(13)
    _, q = _pair(rng.normal(size=(2, 24, 4, 32)), "float32")
    _, k = _pair(rng.normal(size=(2, 24, 2, 32)), "float32")
    _, v = _pair(rng.normal(size=(2, 24, 2, 32)), "float32")
    kpos = torch.arange(24, dtype=torch.int32)
    torch.testing.assert_close(
        flash_attention(q, k, v, window=8, k_pos=kpos),
        flash_attention(q, k, v, window=8), atol=0, rtol=0)


def test_scan_wrappers_reject_other_devices():
    x = torch.empty(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rglru_scan(x, x)
    da = torch.empty(1, 4, 8, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        mamba_scan(da, da, torch.empty(1, 4, 4, device="meta"))
