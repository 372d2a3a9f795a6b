"""The port's MoE FFN against the JAX reference's on the CPU.

The reference's params (``moe_init``) and inputs drawn with numpy reach the
port through the state dict, bit for bit.  Both ``moe_impl`` forms of the
reference (``a2a``, ``global``) and its dense oracle ``moe_ref`` are held
against the port's one compact dispatch, at top-k 1, 2 and 4, with and
without the shared expert, in fp32 (2e-5, the reference's own tolerance,
``tests/test_moe.py``) and bf16 (2e-2).  With forced drops
(``capacity_factor=0.5``) the kept picks must be the very picks the
reference's rule keeps on the reference's routing, and the outputs are
compared twice: as they are, and minus the no-drop oracle, so that a
different drop cannot hide behind a small difference.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as RefConfig
from repro.models.moe import moe_apply, moe_init, moe_ref
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import _flatten, _tensor
from repro_torch.models.moe import MoE, dispatch, moe_slots_ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TOPK_SHARED = [(1, 0), (1, 1), (2, 0), (2, 1), (4, 0), (4, 1)]


def _cfgs(**kw):
    base = dict(name="t", family="moe", n_layers=1, d_model=16, n_heads=2,
                n_kv_heads=1, d_ff=32, vocab=64, n_experts=4, top_k=2,
                capacity_factor=16.0)
    base.update(kw)
    return RefConfig(**base), ModelConfig(**base)


def _setup(dtype, seed=0, shape=(2, 8), **kw):
    """(reference params, reference x, port MoE, port x) on equal bits."""
    jcfg, tcfg = _cfgs(param_dtype=dtype, **kw)
    p = jax.tree.map(np.asarray,
                     moe_init(jax.random.PRNGKey(seed), jcfg,
                              getattr(jnp, dtype)))
    moe = MoE(tcfg, getattr(torch, dtype), "cpu", torch.Generator())
    moe.load_state_dict({k: _tensor(v) for k, v in _flatten(p).items()})
    x = np.random.default_rng(seed + 1).normal(
        size=shape + (tcfg.d_model,)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    return (jax.tree.map(jnp.asarray, p), jcfg, jx, moe, tcfg,
            _tensor(np.asarray(jx)))


def _close(port, ref, dtype):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def _ref_kept(p, x, cfg):
    """The picks (flat token * K + k) that the reference keeps, by its own
    rule (``_moe_apply_a2a``: rank in the stable sort by expert;
    ``_moe_apply_global``: the exclusive running count) on its own
    routing."""
    E, K = cfg.n_experts, cfg.top_k
    xt = x.reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ p["router"], axis=-1)
    _, sel = jax.lax.top_k(probs, K)
    flat = np.asarray(sel).reshape(-1)
    cap = int(math.ceil(cfg.capacity_factor * xt.shape[0] * K / E))
    if cfg.moe_impl == "a2a":
        order = np.argsort(flat, kind="stable")
        sorted_e = flat[order]
        start = np.r_[True, sorted_e[1:] != sorted_e[:-1]]
        seg = np.maximum.accumulate(np.where(start, np.arange(flat.size), 0))
        return np.sort(order[np.arange(flat.size) - seg < cap])
    onehot = np.eye(E, dtype=np.int64)[flat]
    pos = (np.cumsum(onehot, 0) - onehot)[np.arange(flat.size), flat]
    return np.flatnonzero(pos < cap)


def _port_kept(moe, x):
    x2 = x.reshape(-1, x.shape[-1])
    _, gate, sel = moe.route(x2)
    return dispatch(x2, gate, sel, moe.w_gate, moe.w_up, moe.w_down,
                    moe.capacity(x2.shape[0]))[1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("topk,shared", TOPK_SHARED)
@pytest.mark.parametrize("impl", ["a2a", "global"])
def test_moe_matches_reference(impl, topk, shared, dtype):
    """Output and aux loss against ``moe_apply`` (no drops at capacity 16)
    and the output against the dense oracle ``moe_ref``; the port's plain
    version, the reference's slot buffer, likewise."""
    p, jcfg, jx, moe, _, tx = _setup(dtype, moe_impl=impl, top_k=topk,
                                     n_shared_experts=shared)
    y_ref, aux_ref = moe_apply(p, jx, jcfg)
    y, aux = moe(tx)
    assert y.dtype == tx.dtype and y.shape == tx.shape
    _close(y, y_ref, dtype)
    _close(y, moe_ref(p, jx, jcfg), dtype)
    np.testing.assert_allclose(aux.item(), float(aux_ref), rtol=1e-5)
    y_slots, aux_slots, picks = moe_slots_ref(moe, tx)
    _close(y_slots, y_ref, dtype)
    assert aux_slots.item() == aux.item()
    assert torch.equal(picks, _port_kept(moe, tx))
    assert picks.numel() == tx.shape[0] * tx.shape[1] * topk   # no drops


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("topk,shared", [(1, 1), (2, 0), (4, 0)])
@pytest.mark.parametrize("impl", ["a2a", "global"])
def test_forced_drops_keep_the_reference_picks(impl, topk, shared, dtype):
    """capacity_factor 0.5: the kept picks equal the reference's exactly;
    the output equals the reference's, and so does its distance from the
    no-drop oracle (which must be large: the drops change the output)."""
    p, jcfg, jx, moe, _, tx = _setup(dtype, seed=3, shape=(2, 32),
                                     moe_impl=impl, top_k=topk,
                                     n_shared_experts=shared,
                                     capacity_factor=0.5)
    kept = _port_kept(moe, tx)
    want = _ref_kept(p, jx, jcfg)
    assert 0 < want.size < 2 * 32 * topk
    np.testing.assert_array_equal(np.sort(kept.numpy()), want)
    y_ref, aux_ref = moe_apply(p, jx, jcfg)
    y, aux = moe(tx)
    _close(y, y_ref, dtype)
    oracle = moe_ref(p, jx, jcfg)
    y_ref = np.asarray(y_ref, np.float32)
    dropped_ref = y_ref - np.asarray(oracle, np.float32)
    dropped = y.float().numpy() - np.asarray(oracle, np.float32)
    assert np.abs(dropped_ref).max() > 1e-4
    # what the drops took away, the same on both sides within the outputs'
    # own tolerance (a bf16 ulp of the output where nothing was dropped)
    assert (np.abs(dropped - dropped_ref)
            <= TOL[dtype] * (1 + np.abs(y_ref))).all()
    np.testing.assert_allclose(aux.item(), float(aux_ref), rtol=1e-5)
    y_slots, _, picks = moe_slots_ref(moe, tx)
    assert torch.equal(picks, kept)
    _close(y_slots, y_ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_calls_give_identical_outputs(dtype):
    _, _, _, moe, _, tx = _setup(dtype, seed=5, shape=(2, 32), top_k=2,
                                 n_shared_experts=1, capacity_factor=0.5)
    y1, aux1 = moe(tx)
    y2, aux2 = moe(tx)
    assert torch.isfinite(y1).all()
    assert torch.equal(y1, y2) and torch.equal(aux1, aux2)


def test_router_stays_fp32_in_a_bf16_model():
    _, tcfg = _cfgs(param_dtype="bfloat16", n_shared_experts=1)
    moe = MoE(tcfg, torch.bfloat16, "cpu", torch.Generator())
    assert moe.router.dtype == torch.float32
    assert {n: t.dtype for n, t in moe.named_parameters()
            if n != "router"} == dict.fromkeys(
        ["w_gate", "w_up", "w_down", "shared.w_gate", "shared.w_up",
         "shared.w_down"], torch.bfloat16)
    p, _, _, loaded, _, tx = _setup("bfloat16", n_shared_experts=1)
    assert np.asarray(p["router"]).dtype == np.float32
    assert loaded.router.dtype == torch.float32
    np.testing.assert_array_equal(loaded.router.numpy(),
                                  np.asarray(p["router"]))
    # the logits are fp32 products of the bf16 activations
    probs, _, _ = loaded.route(tx.reshape(-1, 16))
    assert probs.dtype == torch.float32


def test_counters_count_picks_and_host_syncs(monkeypatch):
    """One host synchronisation a call; kept + dropped = N * K, and the
    kept count is the sum over experts of min(count, capacity)."""
    for name in ("host_syncs", "kept", "dropped"):
        monkeypatch.setattr(dispatch, name, 0)
    _, _, _, moe, _, tx = _setup("float32", seed=7, shape=(2, 32), top_k=2,
                                 capacity_factor=0.5)
    moe(tx)
    sel = moe.route(tx.reshape(-1, 16))[2]
    counts = torch.bincount(sel.reshape(-1), minlength=4)
    cap = moe.capacity(64)
    assert cap == math.ceil(0.5 * 64 * 2 / 4)
    assert dispatch.host_syncs == 1
    assert dispatch.kept == int(counts.clamp(max=cap).sum())
    assert dispatch.kept + dispatch.dropped == 128 and dispatch.dropped > 0
    moe.capacity_factor = moe.n_experts / moe.top_k    # no drops at all
    moe(tx)
    assert dispatch.host_syncs == 2 and dispatch.kept == 128 + int(
        counts.clamp(max=cap).sum())
