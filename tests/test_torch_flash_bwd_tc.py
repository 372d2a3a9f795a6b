"""The tensor-core flash attention backward (``csrc/flash_bwd_tc.cu``) on
the CPU: which backward kernel the plan picks and what raises under
autograd; the kernel's rounding design emulated in PyTorch (64-row tiles,
fp32 accumulators, P and dS entering the products as bf16 or as two bf16
terms) against ``jax.grad`` of the reference's attention
(``repro.kernels.flash_attention.ref.attention_ref``, its plain path: the
reference differentiates plain JAX on the training path), with and without
a sliding window and at head_dim 64 to 256, on the same numpy inputs; its distance to the fp32 gradients against the plain path's
(``attention_bwd_ref``); O's rounding residual in the row deltas, which
keeps a key bias's gradient at the plain path's; and the wrappers counting
no launch on the CPU.

The emulation is code of this file, not the kernel: it checks that the
rounding the kernel was designed with (``"ds"``: dS split, P rounded
once) and the two it was chosen over stay within the tolerance, and how far
each moves the gradients.  It does not check the CUDA source, which only
runs on the card: ``chip_smoke.py``'s phase 9 holds the kernel to
``attention_bwd_ref`` there, within TOL and, row by row, FLASH_ROW_TOL.

Tolerance: the bf16 ``TOL`` of chip_smoke.py (tests/test_kernels.py:15 of
the reference), 2e-2 absolute and relative: the emulation takes bf16
inputs and rounds its outputs to bf16 (2^-9 relative), and rounds P or dS
once more where it does not split them.
"""
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jax_attention
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (_mask, attention_bwd_ref,
                                                     attention_ref)

TOL = 2e-2
TILE = 64
ROOT = Path(__file__).resolve().parents[1]
# the operands rounded as two bf16 terms (split dS, split P): "ds" is the
# kernel's fixed design, the other two the roundings it was chosen over
# (PERF.md)
ROUNDINGS = {"none": (False, False), "ds": (True, False),
             "ds+p": (True, True)}


def _split(x: torch.Tensor, two: bool) -> list:
    """x as the kernel's A operand: bf16(x), and with ``two`` also
    bf16(x - bf16(x)), as fp32 tensors."""
    hi = x.bfloat16().float()
    return [hi, (x - hi).bfloat16().float()] if two else [hi]


def tc_bwd_emulated(q, k, v, o, lse, do, *, causal, chunk, split,
                    window=0, o_lo=None):
    """(dq, dk, dv) in bf16 as ``flash_bwd_tc`` computes them: bf16 q, k, v,
    o, do (B, S, H, D), lse fp32 (B, Hq, Sq) in natural-log units, taken to
    log2 units; P = exp2(s * scale * log2 e - lse2) on the visible pairs
    (causal, ``window``, chunk);
    dK/dV by 64-key tiles walking the G query heads and 64-row query tiles,
    dQ by 64-row tiles walking 64-key tiles; every product of bf16 values
    summed in fp32, P and dS rounded to bf16 (or split, ``split`` a key of
    ``ROUNDINGS``) before the products that take them.  At head_dim 256 the
    kernel's two warpgroups split D and exchange S's P and dP as fp32
    tiles: the same values, so the same emulation.  ``o_lo``: O's rounding
    residual, which the delta pass adds to O where the forward wrote it."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    split_ds, split_p = ROUNDINGS[split]
    scale, l2e = 1.0 / math.sqrt(D), 1.0 / math.log(2.0)
    qf, of, dof = (t.float().transpose(1, 2) for t in (q, o, do))
    kf, vf = (t.float().transpose(1, 2) for t in (k, v))   # B, Hkv, Skv, D
    if o_lo is not None:
        of = of + o_lo.float().transpose(1, 2)
    delta = (dof * of).sum(-1)                             # B, Hq, Sq
    lse2 = lse * l2e
    mask = _mask(Sq, Skv, q.device, causal=causal, window=window,
                 chunk=chunk, q_offset=0, kv_len=Skv,
                 k_pos=None).expand(Sq, Skv)
    dq = torch.zeros(B, Hq, Sq, D)
    dk = torch.zeros(B, Hkv, Skv, D)
    dv = torch.zeros(B, Hkv, Skv, D)

    def p_ds(qs, ks, heads, kh):
        """P and dS (B, Hkv, rows, keys) of query rows qs of query heads
        ``heads`` against keys ks of kv heads ``kh``."""
        s = qf[:, heads, qs] @ kf[:, kh, ks].transpose(-1, -2)
        p = torch.where(mask[qs, ks], torch.exp2(
            s * (scale * l2e) - lse2[:, heads, qs, None]), 0.0)
        dp = dof[:, heads, qs] @ vf[:, kh, ks].transpose(-1, -2)
        return p, p * (dp - delta[:, heads, qs, None])

    kv_heads = torch.arange(Hkv)
    for k0 in range(0, Skv, TILE):          # dK/dV blocks (all kv heads)
        ks = slice(k0, k0 + TILE)
        for g in range(G):
            heads = kv_heads * G + g
            for q0 in range(0, Sq, TILE):
                qs = slice(q0, q0 + TILE)
                p, ds = p_ds(qs, ks, heads, kv_heads)
                for part in _split(p.transpose(-1, -2), split_p):
                    dv[:, :, ks] += part @ dof[:, heads, qs]
                for part in _split(ds.transpose(-1, -2), split_ds):
                    dk[:, :, ks] += part @ qf[:, heads, qs]
    q_heads = torch.arange(Hq)
    for q0 in range(0, Sq, TILE):           # dQ blocks (all query heads)
        qs = slice(q0, q0 + TILE)
        for k0 in range(0, Skv, TILE):
            ks = slice(k0, k0 + TILE)
            _, ds = p_ds(qs, ks, q_heads, q_heads // G)
            for part in _split(ds, split_ds):
                dq[:, :, qs] += part @ kf[:, q_heads // G, ks]
    return tuple(t.mul(c).transpose(1, 2).bfloat16()
                 for t, c in ((dq, scale), (dk, scale), (dv, 1.0)))


def _inputs(case, seed):
    """bf16 q, k, v, do from numpy, the forward's bf16 o and fp32 lse."""
    B, Sq, Skv, Hq, Hkv, D = case
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .bfloat16() for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D),
                                     (B, Skv, Hkv, D)))
    do = torch.from_numpy(rng.standard_normal((B, Sq, Hq, D)).astype(
        np.float32)).bfloat16()
    return q, k, v, do


def _jax_grads(q, k, v, do, causal, chunk, window=0):
    """jax.grad of the reference's attention at fp32 copies of the bf16
    inputs, in model layout."""
    qn, kn, vn, don = (t.float().numpy().transpose(0, 2, 1, 3)
                       for t in (q, k, v, do))

    def f(a, b, c):
        return jnp.sum(jax_attention(a, b, c, causal=causal, chunk=chunk,
                                     window=window) * jnp.asarray(don))

    g = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(qn), jnp.asarray(kn),
                                        jnp.asarray(vn))
    return [torch.from_numpy(np.asarray(x).transpose(0, 2, 1, 3).copy())
            for x in g]


def _rel_rms(a, b) -> float:
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item()


# (B, Sq, Skv, Hq, Hkv, D), causal, chunk: causal, chunk (aligned with the
# tiles and not) and none with Sq != Skv; ragged lengths; G 1, 4, 7; D 64,
# 96, 128; S up to 300
CASES = [
    ((1, 300, 300, 7, 1, 128), True, 0),
    ((2, 77, 77, 4, 1, 128), True, 0),
    ((1, 130, 130, 4, 4, 64), True, 0),
    ((1, 203, 203, 7, 1, 96), True, 40),
    ((2, 150, 150, 8, 2, 64), True, 64),
    ((1, 100, 260, 4, 1, 96), False, 0),
    ((1, 190, 70, 7, 1, 128), False, 0),
    ((1, 96, 96, 1, 1, 96), True, 0),
]
# (B, Sq, Skv, Hq, Hkv, D), causal, window: recurrentgemma-2b's head shape
# (MQA 10:1, D 256) under a window of 40 (cutting the 64-row tiles) and of
# 64 (tile-aligned), causal and not, and D 128 and 64 windows over ragged
# lengths
WINDOW_CASES = [
    ((1, 256, 256, 10, 1, 256), True, 40),
    ((1, 231, 231, 10, 1, 256), True, 64),
    ((1, 203, 203, 7, 1, 128), True, 50),
    ((1, 90, 150, 4, 2, 96), False, 33),
    ((2, 150, 150, 8, 2, 64), True, 100),
]


@pytest.mark.parametrize("split", list(ROUNDINGS))
@pytest.mark.parametrize("case,causal,chunk", CASES,
                         ids=lambda c: "-".join(map(str, c))
                         if isinstance(c, tuple) else str(c))
def test_emulated_tc_backward_matches_jax_grad(case, causal, chunk, split):
    q, k, v, do = _inputs(case, seed=sum(case) + chunk)
    o, lse = attention_ref(q, k, v, causal=causal, chunk=chunk,
                           return_lse=True)
    got = tc_bwd_emulated(q, k, v, o, lse, do, causal=causal, chunk=chunk,
                          split=split)
    want = _jax_grads(q, k, v, do, causal, chunk)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), rtol=TOL,
                                   atol=TOL, err_msg=f"{name} {split}")


@pytest.mark.parametrize("case,causal,window", WINDOW_CASES,
                         ids=lambda c: "-".join(map(str, c))
                         if isinstance(c, tuple) else str(c))
def test_emulated_tc_backward_with_a_window_matches_jax_grad(case, causal,
                                                             window):
    """The design at the kernel's fixed rounding (dS split) under a sliding
    window, D 256 included, against ``jax.grad`` of the reference's
    windowed attention; without the window dk would differ."""
    q, k, v, do = _inputs(case, seed=sum(case) + window)
    o, lse = attention_ref(q, k, v, causal=causal, window=window,
                           return_lse=True)
    got = tc_bwd_emulated(q, k, v, o, lse, do, causal=causal, chunk=0,
                          split="ds", window=window)
    want = _jax_grads(q, k, v, do, causal, 0, window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), rtol=TOL,
                                   atol=TOL, err_msg=name)
    full = _jax_grads(q, k, v, do, causal, 0)
    assert not np.allclose(full[1].numpy(), want[1].numpy(), rtol=TOL,
                           atol=TOL)


def emulated_error_ratios(case=(1, 1024, 1024, 7, 1, 128), causal=True,
                          chunk=0, seed=0) -> dict:
    """Per rounding of ``ROUNDINGS``: the emulated kernel's rel-RMS
    distance to the fp32 gradients over the plain path's, for dq, dk, dv
    (bf16 inputs; fp32 gradients from ``attention_bwd_ref`` on fp32 copies
    of them with the fp32 forward; the plain path ``attention_bwd_ref`` on
    the bf16 inputs, which computes in fp32 and rounds its outputs)."""
    q, k, v, do = _inputs(case, seed)
    o, lse = attention_ref(q, k, v, causal=causal, chunk=chunk,
                           return_lse=True)
    f32 = [t.float() for t in (q, k, v)]
    o32, lse32 = attention_ref(*f32, causal=causal, chunk=chunk,
                               return_lse=True)
    exact = attention_bwd_ref(*f32, o32, lse32, do.float(), causal=causal,
                              chunk=chunk)
    plain = attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                              chunk=chunk)
    floor = [_rel_rms(p, e) for p, e in zip(plain, exact)]
    out = {}
    for split in ROUNDINGS:
        got = tc_bwd_emulated(q, k, v, o, lse, do, causal=causal,
                              chunk=chunk, split=split)
        out[split] = {n: _rel_rms(g, e) / f for n, g, e, f in
                      zip(("dq", "dk", "dv"), got, exact, floor)}
    return out


def test_split_operands_cost_no_error_beyond_the_plain_path():
    """At qwen2-7b's head shape (G 7, D 128, causal, 1024 positions): an
    output whose operands are all split (dq and dk take dS, dv takes P) is
    no further from the fp32 gradients than the plain path, within 5%; one
    whose operand is rounded once more is further, by less than 2x.  The
    design's dq and dk (dS split) sit at the plain path's error."""
    ratios = emulated_error_ratios()
    for split, r in ratios.items():
        ds, p = ROUNDINGS[split]
        for name, two in (("dq", ds), ("dk", ds), ("dv", p)):
            if two:
                assert r[name] <= 1.05, (split, r)
            else:
                assert 1.05 < r[name] < 2.0, (split, r)


def _output_residual(q, k, v, **masks):
    """O's rounding residual as ``tc_prefill`` writes it beside O: the fp32
    output less its bf16 rounding, in bf16 (the fp32 output here is the
    plain version's on fp32 copies of the inputs)."""
    o32 = attention_ref(q.float(), k.float(), v.float(), **masks)
    return (o32 - o32.bfloat16().float()).bfloat16()


@pytest.mark.parametrize("case", [(1, 256, 256, 32, 2, 128),
                                  (1, 256, 256, 28, 4, 128)],
                         ids=["chatglm3-6b G16", "qwen2-7b G7"])
def test_output_residual_keeps_the_key_bias_gradient_of_the_plain_path(
        case):
    """The row deltas over the rounded O alone miss sum_j P_ij dP_ij by
    dO . (O's rounding), so the row sums of dS stop being zero and the
    gradient of a key bias, sum_j dK_j (zero wherever the softmax ignores a
    shift of a row's scores), grows with the query heads a kv head sums:
    at chatglm3-6b's head shape the emulated kernel's is ~1.5x the plain
    path's (autograd through ``attention_ref``).  With the residual
    ``o_lo`` in the deltas, the plain version and the emulated kernel sit
    at the plain path's, and so does dk's distance to ``jax.grad``."""
    q, k, v, do = _inputs(case, seed=3)
    o, lse = attention_ref(q, k, v, return_lse=True)
    o_lo = _output_residual(q, k, v)
    qt, kt, vt = (t.detach().requires_grad_() for t in (q, k, v))
    plain = torch.autograd.grad(attention_ref(qt, kt, vt), (qt, kt, vt), do)
    exact = _jax_grads(q, k, v, do, True, 0)

    def bias(dk):
        return dk.float().sum(1).norm().item()

    floor = bias(plain[1])
    dk_floor = _rel_rms(plain[1], exact[1])
    assert bias(exact[1]) < 1e-3 * floor
    for residual in (None, o_lo):
        for got in (attention_bwd_ref(q, k, v, o, lse, do, o_lo=residual),
                    tc_bwd_emulated(q, k, v, o, lse, do, causal=True,
                                    chunk=0, split="ds", o_lo=residual)):
            ratio = bias(got[1]) / floor
            dk_ratio = _rel_rms(got[1], exact[1]) / dk_floor
            if residual is None:
                assert ratio > 1.2, ratio
            else:
                assert ratio < 1.05 and dk_ratio < 1.02, (ratio, dk_ratio)


# ---- chip_smoke.py's row check of the backward, on the CPU ----

@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.DEV = "cpu"
    return mod


def _bwd_fp64(q, k, v, o, lse, do, *, causal, chunk):
    """``attention_bwd_ref``'s formulas in fp64 (the exact gradients of the
    given o and lse, up to fp64's rounding), in fp32."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf, of, dof = (t.double().transpose(1, 2) for t in (q, o, do))
    kf = k.double().transpose(1, 2).repeat_interleave(G, dim=1)
    vf = v.double().transpose(1, 2).repeat_interleave(G, dim=1)
    mask = _mask(Sq, Skv, q.device, causal=causal, window=0, chunk=chunk,
                 q_offset=0, kv_len=Skv, k_pos=None)
    s = qf @ kf.transpose(-1, -2) / math.sqrt(D)
    p = torch.where(mask, torch.exp(s - lse.double()[..., None]), 0.0)
    ds = p * (dof @ vf.transpose(-1, -2) - (dof * of).sum(-1)[..., None])
    dq = ds @ kf / math.sqrt(D)
    dk = (ds.transpose(-1, -2) @ qf / math.sqrt(D)).view(
        B, Hkv, G, Skv, D).sum(2)
    dv = (p.transpose(-1, -2) @ dof).view(B, Hkv, G, Skv, D).sum(2)
    return tuple(t.transpose(1, 2).float() for t in (dq, dk, dv))


def test_bwd_rows_leave_out_only_the_gradients_that_are_zero(chip_smoke):
    """A query that sees one key (causal row 0, a chunk's first row) has
    dq = 0; a key seen only by such queries has dk = 0; nothing else is
    left out of the row check."""
    rows = chip_smoke.bwd_rows(203, 203, True, 40)
    assert (~rows["dq"]).nonzero().flatten().tolist() == [0, 40, 80, 120,
                                                          160, 200]
    assert rows["dk"].all() and rows["dv"].all()
    rows = chip_smoke.bwd_rows(201, 201, True, 40)   # a chunk of one row
    assert (~rows["dk"]).nonzero().flatten().tolist() == [200]
    rows = chip_smoke.bwd_rows(100, 150, False, 0)
    assert all(r.all() for r in rows.values())


@pytest.mark.parametrize("case,causal,chunk", CASES[:6],
                         ids=lambda c: "-".join(map(str, c))
                         if isinstance(c, tuple) else str(c))
def test_row_check_passes_the_design_and_fails_a_dropped_key(
        chip_smoke, case, causal, chunk):
    """``bwd_check`` (TOL and, in bf16, FLASH_ROW_TOL row by row) admits the
    emulated kernel at its fixed rounding (dS split) against the plain
    version, and the plain version without the last key fails its row
    check on dk and dv (``bwd_last_key_probe`` raises otherwise)."""
    q, k, v, do = _inputs(case, seed=sum(case) + chunk)
    o, lse = attention_ref(q, k, v, causal=causal, chunk=chunk,
                           return_lse=True)
    refs = attention_bwd_ref(q, k, v, o, lse, do, causal=causal, chunk=chunk)
    got = tc_bwd_emulated(q, k, v, o, lse, do, causal=causal, chunk=chunk,
                          split="ds")
    errs = chip_smoke.bwd_check("emulated", got, refs, torch.bfloat16,
                                causal, chunk)
    assert max(errs[n + "_row"] for n in ("dq", "dk", "dv")) <= \
        chip_smoke.FLASH_ROW_TOL[torch.bfloat16] / 2
    probe = chip_smoke.bwd_last_key_probe(q, k, v, o, lse, do, refs,
                                          causal, chunk)
    assert min(p["row_err"] for p in probe.values()) > 0.1


@pytest.mark.parametrize("case,causal,window", WINDOW_CASES[:3],
                         ids=lambda c: "-".join(map(str, c))
                         if isinstance(c, tuple) else str(c))
def test_row_check_passes_the_design_with_a_window(chip_smoke, case, causal,
                                                   window):
    """``bwd_check`` with the window's rows admits the emulated kernel under
    a window (D 256 and 128), and the last-key probe fails a kernel that
    drops the last key."""
    q, k, v, do = _inputs(case, seed=sum(case) + window)
    o, lse = attention_ref(q, k, v, causal=causal, window=window,
                           return_lse=True)
    refs = attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                             window=window)
    got = tc_bwd_emulated(q, k, v, o, lse, do, causal=causal, chunk=0,
                          split="ds", window=window)
    errs = chip_smoke.bwd_check("emulated", got, refs, torch.bfloat16,
                                causal, 0, window)
    assert max(errs[n + "_row"] for n in ("dq", "dk", "dv")) <= \
        chip_smoke.FLASH_ROW_TOL[torch.bfloat16] / 2
    probe = chip_smoke.bwd_last_key_probe(q, k, v, o, lse, do, refs,
                                          causal, 0, window)
    assert min(p["row_err"] for p in probe.values()) > 0.1


def test_fp32_rows_of_few_keys_sit_beyond_the_row_tol_by_rounding_alone(
        chip_smoke):
    """Why fp32 is held to TOL only: the fp32 plain version against the
    same formulas in fp64 keeps within TOL, and yet a dq row of a few
    visible keys whose terms cancel sits beyond FLASH_ROW_TOL (2e-5) of its
    own scale, where only rounding tells the two apart."""
    case, chunk = (1, 203, 203, 7, 1, 96), 40
    q, k, v, do = (t.float() for t in _inputs(case, seed=3))
    o, lse = attention_ref(q, k, v, causal=True, chunk=chunk,
                           return_lse=True)
    plain = attention_bwd_ref(q, k, v, o, lse, do, causal=True, chunk=chunk)
    exact = _bwd_fp64(q, k, v, o, lse, do, causal=True, chunk=chunk)
    errs = chip_smoke.bwd_check("fp32", plain, exact, torch.float32, True,
                                chunk)
    assert max(errs.values()) <= chip_smoke.TOL[torch.float32]
    rows = chip_smoke.bwd_rows(203, 203, True, chunk)["dq"]
    row_err = chip_smoke.row_scaled_err(plain[0][:, rows], exact[0][:, rows])
    assert row_err > chip_smoke.FLASH_ROW_TOL[torch.float32]


# ---- the plan and the autograd guard ----

@pytest.mark.parametrize("D,dtype,want", [
    (64, torch.bfloat16, "tc"), (96, torch.bfloat16, "tc"),
    (128, torch.bfloat16, "tc"), (16, torch.bfloat16, "simt"),
    (32, torch.bfloat16, "simt"), (64, torch.float32, "simt"),
    (128, torch.float32, "simt"), (16, torch.float32, "simt"),
    (256, torch.bfloat16, "tc"), (256, torch.float32, "simt"),
])
def test_plan_bwd_takes_tc_for_bf16_at_64_96_128(D, dtype, want):
    assert flash_ops.plan_bwd(8, 1024, 1024, 28, 4, D, dtype) == want
    assert flash_ops.plan_bwd(8, 1024, 1024, 28, 4, D, dtype,
                              impl="simt") == "simt"
    if want == "tc":
        assert flash_ops.plan_bwd(2, 77, 77, 4, 1, D, dtype, "tc") == "tc"
    else:
        with pytest.raises(ValueError, match="does not take"):
            flash_ops.plan_bwd(8, 1024, 1024, 28, 4, D, dtype, impl="tc")


def test_plan_bwd_raises_for_other_head_dims_and_kernels():
    for D in (80, 48):
        with pytest.raises(ValueError, match="head_dim"):
            flash_ops.plan_bwd(1, 64, 64, 2, 1, D, torch.bfloat16)
    with pytest.raises(ValueError, match="does not take"):
        flash_ops.plan_bwd(1, 64, 64, 2, 1, 64, torch.bfloat16,
                           impl="tc_prefill")
    assert set(flash_ops.BWD_TC_HEAD_DIMS) < set(flash_ops.BWD_HEAD_DIMS)


@pytest.mark.parametrize("kw", [
    dict(window=16, k_pos=True), dict(k_pos=True), dict(q_offset=3),
    dict(kv_len=100), dict(impl="warp_decode"), dict(splits=2), dict(D=80),
])
def test_autograd_guard_raises_where_no_backward_kernel_takes_a_call(kw):
    kw = dict(kw)
    D = kw.pop("D", 128)
    with pytest.raises(NotImplementedError, match="backward kernel"):
        flash_ops.check_grad_call(D, 128, **kw)
    flash_ops.check_grad_call(128, 128)
    flash_ops.check_grad_call(64, 128, kv_len=128)


def test_cpu_calls_under_autograd_count_no_backward_launch():
    """On the CPU the forward and the backward take the plain versions:
    neither kernel's entry of ``impl_launches`` moves, nor the total."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 80, 4, 64)).astype(
        np.float32)).bfloat16().requires_grad_() for _ in range(3))
    impls = dict(flash_ops.flash_attention_bwd.impl_launches)
    n_bwd = flash_ops.flash_attention_bwd.launches
    flash_ops.flash_attention(q, k, v).float().sum().backward()
    assert q.grad is not None and k.grad is not None
    o, lse = attention_ref(q.detach(), k.detach(), v.detach(),
                           return_lse=True)
    flash_ops.flash_attention_bwd(q.detach(), k.detach(), v.detach(), o, lse,
                                  torch.ones_like(o), impl="tc")
    assert set(impls) == set(flash_ops.BWD_IMPLS)
    assert flash_ops.flash_attention_bwd.impl_launches == impls
    assert flash_ops.flash_attention_bwd.launches == n_bwd
