"""The scans' backward on the CPU: the plain versions of the two backward
kernels (``rglru_gated_bwd_ref``, ``mamba_scan_bwd_ref``) against
``torch.autograd.grad`` of the port's forward plain versions and against
``jax.grad`` of the reference's math (``rglru_mix``'s gate arithmetic with
``linear_scan_chunked`` at its chunk of 256; ``linear_scan_chunked`` at 128
plus ``mamba_mix``'s einsum), with ragged lengths that cross the
reference's chunk, a non-zero h0 and a dh_last; the wrappers' CPU path under
autograd; and ``DiscretiseBx``, the Mamba block's ``dt (x) B * xc``, against
autograd of the eager expression.  The RG-LRU's backward reads the states its
forward keeps (one a chunk of ``BWD_STEPS`` steps): their plain version
``rglru_states_ref`` against the reference's ``linear_scan``, the plain
backward given them, their checks, the plan's refusals and which calls keep
them.  The CUDA kernels are held to these plain versions on the card by
``chip_smoke.py``.

Tolerance: fp32, 2e-5 absolute and relative (tests/test_torch_train_
kernels.py's ``TOL``): both sides compute in fp32 and differ by summation
order only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.rglru import _C as JAX_C
from repro.models.scan_ops import linear_scan, linear_scan_chunked
from repro_torch.kernels.mamba_scan import ops as mamba_ops
from repro_torch.kernels.mamba_scan.ref import (mamba_scan_bwd_ref,
                                                mamba_scan_ref)
from repro_torch.kernels.rglru_scan import ops as rglru_ops
from repro_torch.kernels.rglru_scan.ref import (rglru_gated_bwd_ref,
                                                rglru_gated_ref,
                                                rglru_states_ref)
from repro_torch.models.mamba import DiscretiseBx

TOL = 2e-5
GATED_NAMES = ("dxa", "dxi", "dxc", "db_a", "db_i", "dlam", "dh0")


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL,
                               err_msg=what)


def _gated_inputs(rng, B, S, W):
    """xa, xi, xc, dh unit normal; b_a, b_i normal * 0.5; lambda as the
    model draws it (a^8 uniform in [0.9, 0.999]); h0 and dh_last unit
    normal: numpy fp32."""
    xa, xi, xc, dh = (rng.standard_normal((B, S, W)).astype(np.float32)
                      for _ in range(4))
    b_a, b_i = (0.5 * rng.standard_normal(W).astype(np.float32)
                for _ in range(2))
    u = rng.uniform(0.9, 0.999, W)
    lam = np.log(np.expm1(-np.log(u) / 8.0)).astype(np.float32)
    h0, dh_last = (rng.standard_normal((B, W)).astype(np.float32)
                   for _ in range(2))
    return (xa, xi, xc, b_a, b_i, lam), h0, dh, dh_last


def _jax_gated(xa, xi, xc, b_a, b_i, lam, h0):
    """``rglru_mix``'s gate arithmetic and scan (chunk 256), from h0."""
    r = jax.nn.sigmoid(xa + b_a)
    i = jax.nn.sigmoid(xi + b_i)
    a = jnp.exp(JAX_C * r * -jax.nn.softplus(lam))
    b = jnp.sqrt(jnp.maximum(1.0 - a * a, 1e-12)) * i * xc
    return linear_scan_chunked(a, b, h0, chunk=256)


# (B, S, W, h0, dh_last): S across the reference's chunk of 256 (ragged),
# within one chunk, one step; W not a multiple of the kernel's 128 threads
GATED_CASES = [(2, 300, 12, True, True), (1, 257, 5, False, False),
               (2, 40, 7, True, False), (3, 1, 4, True, True),
               (1, 70, 130, False, True)]


@pytest.mark.parametrize("case", GATED_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_rglru_gated_bwd_ref_matches_autograd_and_jax_grad(case):
    B, S, W, with_h0, with_dh_last = case
    rng = np.random.default_rng(S + W)
    args, h0n, dhn, dh_lastn = _gated_inputs(rng, B, S, W)
    h0n = h0n if with_h0 else np.zeros_like(h0n)
    dh_lastn = dh_lastn if with_dh_last else np.zeros_like(dh_lastn)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    h0 = torch.from_numpy(h0n).requires_grad_() if with_h0 else None
    dh, dh_last = torch.from_numpy(dhn), torch.from_numpy(dh_lastn)
    got = rglru_gated_bwd_ref(*(t.detach() for t in leaves),
                              None if h0 is None else h0.detach(), dh,
                              dh_last if with_dh_last else None)
    assert got[6] is None if h0 is None else got[6].shape == (B, W)
    assert all(g.dtype == torch.float32 for g in got if g is not None)
    # given the forward's kept states, the same gradients
    every = rglru_ops.BWD_STEPS
    states = rglru_states_ref(*(t.detach() for t in leaves),
                              None if h0 is None else h0.detach(), every)
    kept = rglru_gated_bwd_ref(*(t.detach() for t in leaves),
                               None if h0 is None else h0.detach(), dh,
                               dh_last if with_dh_last else None, states,
                               every)
    for name, g, k in zip(GATED_NAMES, got, kept):
        assert (g is None) == (k is None), name
        assert g is None or torch.equal(g, k), name

    h, h_last = rglru_gated_ref(*leaves, h0)
    inputs = leaves + ([h0] if h0 is not None else [])
    want = torch.autograd.grad((h, h_last), inputs, (dh, dh_last))
    for name, g, w in zip(GATED_NAMES, got, want):
        _close(g, w, name)

    def f(*a):
        hs, last = _jax_gated(*a)
        return jnp.sum(hs * dhn) + jnp.sum(last * dh_lastn)

    jg = jax.jit(jax.grad(f, argnums=tuple(range(7))))(
        *(jnp.asarray(a) for a in args), jnp.asarray(h0n))
    for name, g, w in zip(GATED_NAMES, got, jg):
        if g is not None:
            _close(g, np.asarray(w), name)


def test_rglru_gated_bwd_ref_rounds_to_the_inputs_dtype():
    """bf16 inputs: dxa, dxi, dxc in bf16, the (W,) sums and dh0 fp32, the
    arithmetic fp32 on the rounded inputs."""
    rng = np.random.default_rng(3)
    args, h0, dh, _ = _gated_inputs(rng, 2, 20, 8)
    xs = [torch.from_numpy(a).bfloat16() for a in args[:3]]
    vecs = [torch.from_numpy(a) for a in args[3:]]
    got = rglru_gated_bwd_ref(*xs, *vecs, torch.from_numpy(h0),
                              torch.from_numpy(dh).bfloat16())
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + \
        [torch.float32] * 4
    want = rglru_gated_bwd_ref(*(x.float() for x in xs), *vecs,
                               torch.from_numpy(h0),
                               torch.from_numpy(dh).bfloat16().float())
    for name, g, w in zip(GATED_NAMES, got, want):
        assert torch.equal(g, w.to(g.dtype)), name


def test_rglru_gated_bwd_ref_stops_at_the_clamp():
    """Where 1 - a^2 is below the clamp (a = 1 to fp32, lambda very
    negative and r near 0), no gradient flows through the square root: from
    a zero state (one step, so h[t-1] = 0 and the recurrence passes none
    either) dxa and dlam are zero, as through ``jnp.maximum``."""
    B, S, W = 1, 1, 3
    xa = torch.full((B, S, W), -40.0)
    xi, xc, dh = (torch.ones(B, S, W) for _ in range(3))
    lam = torch.full((W,), -30.0)
    zeros = torch.zeros(W)
    dxa, _, _, db_a, _, dlam, _ = rglru_gated_bwd_ref(
        xa, xi, xc, zeros, zeros, lam, None, dh)
    a = torch.exp(8 * -torch.nn.functional.softplus(lam) *
                  torch.sigmoid(xa + zeros))
    assert bool((1 - a * a <= 1e-12).all())
    assert not dxa.any() and not db_a.any() and not dlam.any()


def _jax_gates(xa, xi, xc, b_a, b_i, lam):
    """``rglru_mix``'s a and b."""
    r = jax.nn.sigmoid(xa + b_a)
    i = jax.nn.sigmoid(xi + b_i)
    a = jnp.exp(JAX_C * r * -jax.nn.softplus(lam))
    return a, jnp.sqrt(jnp.maximum(1.0 - a * a, 1e-12)) * i * xc


# (B, S, W, h0, every): S across chunks of both sizes (ragged; one shape,
# so the reference's scan compiles once), one chunk, one step
STATES_CASES = [(2, 150, 6, True, 64), (2, 150, 6, False, 32),
                (2, 150, 6, True, 128), (3, 1, 4, True, 32)]


@pytest.mark.parametrize("case", STATES_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_rglru_states_ref_is_the_reference_scan_at_chunk_starts(case):
    """The states the forward keeps for its backward: h0 (zero) first, then
    the fp32 state after every every-th step, from the reference's
    ``linear_scan`` on the reference's gates."""
    B, S, W, with_h0, every = case
    rng = np.random.default_rng(S * 7 + every)
    args, h0n, _, _ = _gated_inputs(rng, B, S, W)
    h0n = h0n if with_h0 else np.zeros_like(h0n)
    got = rglru_states_ref(*(torch.from_numpy(a) for a in args),
                           torch.from_numpy(h0n) if with_h0 else None, every)
    K = -(-S // every)
    assert got.shape == (B, K, W) and got.dtype == torch.float32
    hs, _ = linear_scan(*_jax_gates(*(jnp.asarray(a) for a in args)),
                        jnp.asarray(h0n))
    want = np.concatenate([h0n[:, None], np.asarray(hs)[:, every - 1:S - 1:
                                                         every]], 1)
    _close(got, want, "states")
    assert torch.equal(got[:, 0], torch.from_numpy(h0n))


def test_rglru_gated_bwd_ref_refuses_states_not_the_forwards():
    """The plain backward holds given states to its own recurrence."""
    rng = np.random.default_rng(9)
    args, h0, dh, _ = _gated_inputs(rng, 2, 70, 6)
    ts = [torch.from_numpy(a) for a in args]
    h0, dh = torch.from_numpy(h0), torch.from_numpy(dh)
    every = rglru_ops.BWD_STEPS
    states = rglru_states_ref(*ts, h0, every)
    rglru_gated_bwd_ref(*ts, h0, dh, None, states, every)
    bad = states.clone()
    bad[1, 1, 3] += 0.01
    with pytest.raises(ValueError, match="not the forward"):
        rglru_gated_bwd_ref(*ts, h0, dh, None, bad, every)
    with pytest.raises(ValueError, match="not the forward"):
        rglru_ops.rglru_gated_bwd(*ts, h0, dh, None, bad)


def test_rglru_gated_bwd_checks_the_states():
    """Shape (B, ceil(S / BWD_STEPS), W), fp32, contiguous."""
    rng = np.random.default_rng(10)
    args, h0, dh, _ = _gated_inputs(rng, 2, 70, 6)
    ts = [torch.from_numpy(a) for a in args]
    h0, dh = torch.from_numpy(h0), torch.from_numpy(dh)
    states = rglru_states_ref(*ts, h0, rglru_ops.BWD_STEPS)
    assert states.shape == (2, 2, 6)
    with pytest.raises(ValueError, match="states"):
        rglru_ops.rglru_gated_bwd(*ts, h0, dh, None, states[:, :1].clone())
    with pytest.raises(ValueError, match="states"):   # every 32nd step's
        rglru_ops.rglru_gated_bwd(*ts, h0, dh, None,
                                  rglru_states_ref(*ts, h0, 32))
    with pytest.raises(TypeError, match="states"):
        rglru_ops.rglru_gated_bwd(*ts, h0, dh, None, states.double())
    with pytest.raises(ValueError, match="contiguous"):
        rglru_ops.rglru_gated_bwd(
            *ts, h0, dh, None, states.transpose(0, 1).contiguous()
            .transpose(0, 1))
    with pytest.raises(ValueError, match="states"):
        rglru_ops._check("rglru_gated_bwd", ts[2], {}, {}, None,
                         states[:1].contiguous(), rglru_ops.BWD_STEPS)


def _fake_forward(calls):
    """A stand-in for the forward launch on CPU tensors: the plain outputs
    and, when asked, the plain states; records each call's ``every``."""
    def fwd(xa, xi, xc, b_a, b_i, lam, h0, how, every=0):
        calls.append(every)
        h, h_last = rglru_gated_ref(xa, xi, xc, b_a, b_i, lam, h0)
        kept = (rglru_states_ref(xa, xi, xc, b_a, b_i, lam, h0, every)
                if every else None)
        return h, h_last, kept
    return fwd


def test_states_are_kept_under_grad_only(monkeypatch):
    """The CUDA route (its launch replaced by the plain version): a serving
    call, without grad, asks for no states; under grad ``RGLRUGatedFn``
    asks for BWD_STEPS' and saves them, and its backward hands them to
    ``rglru_gated_bwd``, whose gradients are autograd's of the plain
    forward."""
    calls = []
    monkeypatch.setattr(rglru_ops, "_gated_fwd", _fake_forward(calls))
    rng = np.random.default_rng(11)
    args, h0, _, _ = _gated_inputs(rng, 2, 70, 6)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    h0 = torch.from_numpy(h0)
    how = rglru_ops.plan(2, 70, 6, torch.float32, gated=True,
                         states=rglru_ops.BWD_STEPS)
    with torch.no_grad():
        out = rglru_ops._gated_cuda(*leaves, h0, how, False)
    assert calls == [0] and len(out) == 2
    h, h_last = rglru_ops._gated_cuda(*leaves, h0, how, True)
    assert calls == [0, rglru_ops.BWD_STEPS]
    saved = h.grad_fn.saved_tensors
    assert saved[-1].shape == (2, 2, 6)
    assert torch.equal(saved[-1], rglru_states_ref(
        *(t.detach() for t in leaves), h0, rglru_ops.BWD_STEPS))
    (h.float().sum() + h_last.sum()).backward()
    want = torch.autograd.grad(
        sum(t.float().sum() for t in rglru_gated_ref(*leaves, h0)), leaves)
    for t, w in zip(leaves, want):
        _close(t.grad, w)


def test_states_every_is_not_taken_under_autograd():
    rng = np.random.default_rng(12)
    args, _, _, _ = _gated_inputs(rng, 1, 10, 4)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    with pytest.raises(ValueError, match="autograd"):
        rglru_ops.rglru_gated(*leaves, states_every=32)
    with torch.no_grad():
        h, h_last, kept = rglru_ops.rglru_gated(*leaves, states_every=32)
    assert kept.shape == (1, 1, 4) and not kept.any()


def _jax_mamba(da, dbx, c):
    """``mamba_mix``'s scan (chunk 128) from a zero state, and its einsum."""
    B, _, Di, N = da.shape
    hs, h_last = linear_scan_chunked(da, dbx, jnp.zeros((B, Di, N)),
                                     chunk=128)
    return jnp.einsum("bsdn,bsn->bsd", hs, c), h_last


# (B, S, Di, N, dh_last): S across the reference's chunk of 128 (ragged)
# and the kernel's of 32, each N of the kernel
MAMBA_CASES = [(2, 150, 6, 4, True), (1, 129, 5, 8, False),
               (2, 33, 3, 16, True), (1, 1, 4, 4, True)]


@pytest.mark.parametrize("case", MAMBA_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_mamba_scan_bwd_ref_matches_autograd_and_jax_grad(case):
    B, S, Di, N, with_dh_last = case
    rng = np.random.default_rng(S * N + Di)
    dan = rng.uniform(0.5, 0.99, (B, S, Di, N)).astype(np.float32)
    dbxn = (0.1 * rng.standard_normal((B, S, Di, N))).astype(np.float32)
    cn = rng.standard_normal((B, S, N)).astype(np.float32)
    dyn = rng.standard_normal((B, S, Di)).astype(np.float32)
    dhn = (rng.standard_normal((B, Di, N)).astype(np.float32)
           if with_dh_last else np.zeros((B, Di, N), np.float32))
    da, dbx, c = (torch.from_numpy(a).requires_grad_()
                  for a in (dan, dbxn, cn))
    dy, dh_last = torch.from_numpy(dyn), torch.from_numpy(dhn)
    got = mamba_scan_bwd_ref(da.detach(), dbx.detach(), c.detach(), dy,
                             dh_last if with_dh_last else None)
    assert [tuple(g.shape) for g in got] == [(B, S, Di, N)] * 2 + \
        [(B, S, N)]
    y, h_last = mamba_scan_ref(da, dbx, c)
    want = torch.autograd.grad((y, h_last), (da, dbx, c), (dy, dh_last))
    for name, g, w in zip(("dda", "ddbx", "dc"), got, want):
        _close(g, w, name)

    def f(a, b, cc):
        yj, last = _jax_mamba(a, b, cc)
        return jnp.sum(yj * dyn) + jnp.sum(last * dhn)

    jg = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
        *(jnp.asarray(a) for a in (dan, dbxn, cn)))
    for name, g, w in zip(("dda", "ddbx", "dc"), got, jg):
        _close(g, np.asarray(w), name)


def test_cpu_scan_wrappers_take_the_plain_versions_under_autograd():
    """On the CPU both scans return the plain versions, which autograd
    differentiates, and their backward wrappers return the backward plain
    versions; no kernel counter moves."""
    rng = np.random.default_rng(8)
    args, h0, dh, dh_last = _gated_inputs(rng, 2, 9, 6)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    counts = (rglru_ops.rglru_gated.launches,
              rglru_ops.rglru_gated_bwd.launches,
              mamba_ops.mamba_scan.launches,
              mamba_ops.mamba_scan_bwd.launches)
    h, _ = rglru_ops.rglru_gated(*leaves, torch.from_numpy(h0))
    assert h.grad_fn is not None
    h.sum().backward()
    assert all(t.grad is not None for t in leaves)
    got = rglru_ops.rglru_gated_bwd(*(t.detach() for t in leaves),
                                    torch.from_numpy(h0),
                                    torch.from_numpy(dh),
                                    torch.from_numpy(dh_last))
    want = rglru_gated_bwd_ref(*(t.detach() for t in leaves),
                               torch.from_numpy(h0), torch.from_numpy(dh),
                               torch.from_numpy(dh_last))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    da = torch.rand(1, 7, 3, 4).requires_grad_()
    dbx, c = torch.randn(1, 7, 3, 4).requires_grad_(), torch.randn(1, 7, 4)
    y, _ = mamba_ops.mamba_scan(da, dbx, c)
    y.sum().backward()
    assert da.grad is not None and dbx.grad is not None
    got = mamba_ops.mamba_scan_bwd(da.detach(), dbx.detach(), c,
                                   torch.ones(1, 7, 3))
    want = mamba_scan_bwd_ref(da.detach(), dbx.detach(), c,
                              torch.ones(1, 7, 3))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert counts == (rglru_ops.rglru_gated.launches,
                      rglru_ops.rglru_gated_bwd.launches,
                      mamba_ops.mamba_scan.launches,
                      mamba_ops.mamba_scan_bwd.launches)


def test_rglru_gated_bwd_checks_its_inputs():
    rng = np.random.default_rng(4)
    args, h0, dh, _ = _gated_inputs(rng, 1, 5, 4)
    ts = [torch.from_numpy(a) for a in args]
    with pytest.raises(ValueError, match="dh"):
        rglru_ops.rglru_gated_bwd(*ts, None, torch.zeros(1, 5, 3))
    with pytest.raises(TypeError, match="dh"):
        rglru_ops.rglru_gated_bwd(*ts, None, torch.zeros(1, 5, 4,
                                                         dtype=torch.float64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_discretise_bx_matches_the_eager_expression(dtype):
    """Forward bit-equal to the eager ``(dt[..., None] * B.float())
    .mul_(xc.float())`` (the serve path's bits); the gradients of dt, B and
    xc within TOL of autograd through it, in their own dtypes."""
    g = torch.Generator().manual_seed(2)
    dt = torch.rand(2, 5, 6, generator=g).requires_grad_()
    bmat = torch.randn(2, 5, 4, generator=g).to(dtype).requires_grad_()
    xc = torch.randn(2, 5, 6, generator=g).to(dtype).requires_grad_()
    eager = (dt[..., None] * bmat[:, :, None, :].float()).mul_(
        xc[..., None].float())
    got = DiscretiseBx.apply(dt, bmat, xc)
    assert torch.equal(got, eager)
    up = torch.randn(eager.shape, generator=g)
    want = torch.autograd.grad(eager, (dt, bmat, xc), up)
    have = torch.autograd.grad(got, (dt, bmat, xc), up)
    for name, a, b in zip(("dt", "B", "xc"), have, want):
        assert a.dtype == b.dtype, name
        _close(a, b, name)
