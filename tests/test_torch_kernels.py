"""The port's kernel wrappers on CPU tensors (their plain PyTorch versions)
against the reference's Pallas kernels run in interpret mode, on the shapes
of tests/test_kernels.py.  Inputs come from numpy with a fixed seed and are
rounded to the working dtype once, so both sides see identical values.

Tolerances are the reference's (tests/test_kernels.py:15): fp32 2e-5, bf16
2e-2, absolute and relative.  The CUDA kernels themselves are compiled and
held against the same plain versions on the card by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jax_flash_attention
from repro.kernels import fused_rmsnorm as jax_fused_rmsnorm
from repro_torch.kernels import _build, flash_attention, fused_rmsnorm

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


def _check(out_t, out_j, dtype):
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors take the plain path: no kernel launch is counted."""
    fused_rmsnorm.launches = flash_attention.launches = 0
    yield
    assert fused_rmsnorm.launches == 0
    assert flash_attention.launches == 0


# ---- rmsnorm ----

@pytest.mark.parametrize("N,D", [(16, 64), (37, 128), (5, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_residual", [False, True])
def test_rmsnorm_matches_pallas(N, D, dtype, with_residual):
    rng = np.random.default_rng(5)
    xj, xt = _pair(rng.normal(size=(N, D)), dtype)
    wj, wt = _pair(rng.normal(size=(D,)) * 0.1 + 1.0, dtype)
    rj, rt = _pair(rng.normal(size=(N, D)), dtype)
    if with_residual:
        y, res = fused_rmsnorm(xt, wt, rt)
        yj, resj = jax_fused_rmsnorm(xj, wj, rj, block_rows=16, interpret=True)
        _check(res, resj, dtype)
        assert res.dtype == xt.dtype
    else:
        y = fused_rmsnorm(xt, wt)
        yj = jax_fused_rmsnorm(xj, wj, block_rows=16, interpret=True)
    assert y.dtype == xt.dtype
    _check(y, yj, dtype)


def test_rmsnorm_flattens_leading_dims():
    rng = np.random.default_rng(6)
    xj, xt = _pair(rng.normal(size=(2, 3, 64)), "float32")
    wj, wt = _pair(rng.normal(size=(64,)), "float32")
    y = fused_rmsnorm(xt, wt)
    assert y.shape == (2, 3, 64)
    _check(y, jax_fused_rmsnorm(xj, wj, block_rows=8, interpret=True),
           "float32")


# ---- flash attention ----

def _qkv(B, Sq, Skv, Hq, Hkv, D, dtype, seed):
    rng = np.random.default_rng(seed)
    return (_pair(rng.normal(size=(B, Sq, Hq, D)), dtype),
            _pair(rng.normal(size=(B, Skv, Hkv, D)), dtype),
            _pair(rng.normal(size=(B, Skv, Hkv, D)), dtype))


@pytest.mark.parametrize("B,S,Hq,Hkv,D", [
    (1, 64, 4, 4, 32),      # MHA
    (2, 80, 4, 2, 32),      # GQA, non-multiple S
    (1, 33, 8, 1, 16),      # MQA, ragged S
    (1, 45, 4, 4, 96),      # phi-3-vision's head_dim: MHA, ragged S
    (2, 70, 4, 2, 96),      # ... GQA, ragged S
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_causal_matches_pallas(B, S, Hq, Hkv, D, dtype):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(B, S, S, Hq, Hkv, D, dtype, 0)
    out = flash_attention(qt, kt, vt)
    ref = jax_flash_attention(qj, kj, vj, block_q=32, block_kv=32,
                              interpret=True)
    assert out.shape == (B, S, Hq, D) and out.dtype == qt.dtype
    _check(out, ref, dtype)


@pytest.mark.parametrize("mode", [dict(window=16), dict(chunk=32),
                                  dict(causal=False)])
def test_flash_attention_masks_match_pallas(mode):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(2, 96, 96, 4, 2, 32, "float32", 1)
    kwargs = {"causal": True, **mode}
    out = flash_attention(qt, kt, vt, **kwargs)
    ref = jax_flash_attention(qj, kj, vj, block_q=32, block_kv=32,
                              interpret=True, **kwargs)
    _check(out, ref, "float32")


@pytest.mark.parametrize("kv_len", [None, 64])
def test_flash_attention_decode_offset_matches_pallas(kv_len):
    """Decode: one query at position Skv - 1 over the keys.  With a longer
    cache buffer, ``kv_len`` masks the unwritten slots (zeros here)."""
    Skv = 64
    (qj, qt), (kj, kt), (vj, vt) = _qkv(2, 1, Skv, 4, 2, 32, "float32", 2)
    if kv_len is not None:       # the same keys at the front of a buffer
        kt = torch.cat([kt, torch.zeros(2, 16, 2, 32)], 1)
        vt = torch.cat([vt, torch.zeros(2, 16, 2, 32)], 1)
    out = flash_attention(qt, kt, vt, q_offset=Skv - 1, kv_len=kv_len)
    ref = jax_flash_attention(qj, kj, vj, q_offset=Skv - 1, block_q=8,
                              block_kv=32, interpret=True)
    _check(out, ref, "float32")


def test_flash_attention_whole_buffer_under_causal_mask():
    """Decode over the whole cache buffer with only the causal mask equals
    decode over the written prefix (``kv_len = pos + 1``)."""
    (_, qt), (_, kt), (_, vt) = _qkv(2, 1, 80, 4, 2, 32, "float32", 3)
    a = flash_attention(qt, kt, vt, q_offset=50)
    b = flash_attention(qt, kt, vt, q_offset=50, kv_len=51)
    torch.testing.assert_close(a, b, atol=TOL["float32"], rtol=TOL["float32"])


def test_wrappers_reject_other_devices():
    x = torch.empty(2, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_rmsnorm(x, torch.empty(4, device="meta"))
    q = torch.empty(1, 1, 2, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q, q, q)


# ---- build ----

def test_build_names_one_library_per_source(tmp_path, monkeypatch):
    """Every ``csrc/*.cu`` is a source; its library is keyed by a hash of
    the sources, so an edit (of the file or of a shared header) rebuilds."""
    assert _build.sources() == ["flash_attention", "flash_attention_bwd",
                                "flash_bwd_tc", "flash_decode",
                                "flash_prefill_tc", "ga_labels",
                                "mamba_scan", "rglru_scan", "rmsnorm"]
    for name in ("rmsnorm.cu", "common.cuh"):
        (tmp_path / name).write_bytes((_build.CSRC / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._lib_path("rmsnorm")
    assert before.parent == _build.BUILD_DIR and before.name.startswith("rmsnorm-")
    (tmp_path / "common.cuh").write_text("// edited\n")
    after_header = _build._lib_path("rmsnorm")
    (tmp_path / "rmsnorm.cu").write_text("// edited\n")
    assert len({before, after_header, _build._lib_path("rmsnorm")}) == 3


def test_build_check_raises_on_launch_error():
    _build.check(0, "ok")
    with pytest.raises(RuntimeError, match="error 700"):
        _build.check(700, "flash_attention_fwd")
