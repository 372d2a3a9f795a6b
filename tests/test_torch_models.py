"""The port's chatglm3-6b and qwen2-7b model paths against the JAX reference
on the CPU.

The reduced config runs in fp32 on both sides (the reference's dense
attention rounds its probabilities to the dtype before P.V, the port's flash
kernel does not, so they agree tightly only in fp32).  The QKV biases and
norm scales are perturbed with numpy: at init they are 0 and 1, which would
hide a bias or scale bug.  Reference weights reach the port through
``params_from_jax``.

Tolerance for logits: 1e-4 absolute and relative.  The port's softmax is
online (per key tile) and the reference's direct, and the matmuls sum in
another order, so fp32 results differ by ~1e-6 relative, grown through the
layers to ~1e-5 at the logits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import chatglm3_6b as jax_chatglm
from repro.models import common as jax_common
from repro.models import transformer as T
from repro_torch.configs import chatglm3_6b, get_config, get_reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.models import common
from repro_torch.models.transformer import Transformer, check_ported

TOL = 1e-4
ARCH = "chatglm3-6b"


def _cfgs():
    jcfg = dataclasses.replace(jax_chatglm.reduced(), param_dtype="float32")
    tcfg = dataclasses.replace(get_reduced(ARCH), param_dtype="float32")
    return jcfg, tcfg


@pytest.fixture(scope="module")
def models():
    """(JAX params, reference cfg, port model, port cfg) on equal weights."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(0)
    np_params = jax.tree.map(np.asarray, T.init_params(jcfg, jax.random.PRNGKey(0)))

    def perturb(path, a):
        leaf = path[-1].key
        if leaf in ("bq", "bk", "bv", "scale"):
            return (a + rng.normal(0.0, 0.5, a.shape)).astype(a.dtype)
        return a

    np_params = jax.tree_util.tree_map_with_path(perturb, np_params)
    model = Transformer(tcfg, "cpu")
    model.load_state_dict(params_from_jax(np_params, tcfg))
    return jax.tree.map(jnp.asarray, np_params), jcfg, model, tcfg


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               atol=TOL, rtol=TOL)


def test_forward_matches_reference(models):
    params, jcfg, model, tcfg = models
    toks = np.random.default_rng(1).integers(0, tcfg.vocab, (2, 24))
    ref, _ = T.forward(params, jcfg, {"tokens": jnp.asarray(toks)})
    out = model(torch.from_numpy(toks))
    assert out.shape == (2, 24, tcfg.vocab) and out.dtype == torch.float32
    _close(out, ref)


def test_prefill_and_decode_match_reference(models):
    """Prefill, then 8 decode steps on the same (random) tokens."""
    params, jcfg, model, tcfg = models
    rng = np.random.default_rng(2)
    B, S, steps = 2, 12, 8
    toks = rng.integers(0, tcfg.vocab, (B, S))
    feed = rng.integers(0, tcfg.vocab, (steps, B, 1))
    lg, caches, _ = T.prefill(params, jcfg, {"tokens": jnp.asarray(toks)},
                              max_len=S + steps, cache_dtype=jnp.float32)
    out, cache = model.prefill(torch.from_numpy(toks), max_len=S + steps)
    _close(out, lg)
    step = jax.jit(lambda p, tok, pos, c: T.decode_step(p, jcfg, tok, pos, c))
    for i in range(steps):
        lg, caches = step(params, jnp.asarray(feed[i]), jnp.int32(S + i),
                          caches)
        out, cache = model.decode_step(torch.from_numpy(feed[i]), S + i, cache)
        assert out.shape == (B, 1, tcfg.vocab)
        _close(out, lg)
    # the cache holds what the reference's holds, slot for slot
    ref_k = np.asarray(caches["seg0"]["pos0"]["attn"]["k"])
    port_k = torch.stack([c["k"] for c in cache.layers])
    np.testing.assert_allclose(port_k.numpy(), ref_k, atol=TOL, rtol=TOL)
    assert cache.length == S + steps


def test_decode_rejects_out_of_order_positions(models):
    _, _, model, tcfg = models
    _, cache = model.prefill(torch.zeros(1, 4, dtype=torch.long), max_len=5)
    with pytest.raises(ValueError, match="position"):
        model.decode_step(torch.zeros(1, 1, dtype=torch.long), 7, cache)
    model.decode_step(torch.zeros(1, 1, dtype=torch.long), 4, cache)
    with pytest.raises(ValueError, match="full"):
        model.decode_step(torch.zeros(1, 1, dtype=torch.long), 5, cache)


def test_model_feeds_kernels_contiguous_tensors(models, monkeypatch):
    """On the card the kernel wrappers refuse non-contiguous tensors, which
    the plain CPU path would accept: check what the model hands them, and
    how often (per forward: two norms a layer plus the final one, one
    attention a layer)."""
    from repro_torch.models import attention as attn_mod
    _, _, model, tcfg = models
    calls = {"rmsnorm": 0, "flash_attention": 0}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            for t in args:
                assert t.is_contiguous(), f"{name} got a non-contiguous tensor"
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(common, "fused_rmsnorm",
                        spy("rmsnorm", common.fused_rmsnorm))
    monkeypatch.setattr(attn_mod, "flash_attention",
                        spy("flash_attention", attn_mod.flash_attention))
    toks = torch.randint(0, tcfg.vocab, (3, 9),
                         generator=torch.Generator().manual_seed(5))
    _, cache = model.prefill(toks, max_len=12)
    model.decode_step(toks[:, :1], 9, cache)
    model(toks)
    L = tcfg.n_layers
    assert calls == {"rmsnorm": 3 * (2 * L + 1), "flash_attention": 3 * L}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_partial_matches_reference(dtype):
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(2, 7, 4, 128)), jnp.float32).astype(dtype)
    pos = np.arange(5, 12)
    ref = jax_common.apply_rope(x, jnp.asarray(pos)[None], fraction=0.5,
                                theta=10_000.0)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        getattr(torch, dtype))
    out = common.apply_rope(xt, torch.from_numpy(pos)[None], fraction=0.5,
                            theta=10_000.0)
    assert out.dtype == xt.dtype
    # the second half of each head (64 of 128 dims) is not rotated
    assert torch.equal(out[..., 64:], xt[..., 64:])
    tol = 2e-2 if dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol, rtol=tol)


def test_rope_freqs_match_reference():
    inv, rot = common.rope_freqs(128, 0.5, 10_000.0)
    ref_inv, ref_rot = jax_common.rope_freqs(128, 0.5, 10_000.0)
    assert rot == ref_rot == 64
    np.testing.assert_allclose(inv.numpy(), np.asarray(ref_inv), rtol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(dtype):
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.normal(size=(3, 5, 64)), jnp.float32).astype(dtype)
    w = jnp.asarray(rng.normal(size=(64,)) + 1.0, jnp.float32).astype(dtype)
    ref = jax_common.rmsnorm(w, x)
    conv = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(  # noqa: E731
        getattr(torch, dtype))
    out = common.rmsnorm(conv(w), conv(x))
    assert out.dtype == getattr(torch, dtype)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("name", ["silu", "gelu", "relu"])
def test_act_fn_matches_reference(name):
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    ref = jax_common.act_fn(name)(jnp.asarray(x))
    out = common.act_fn(name)(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=1e-6)


def test_config_matches_reference():
    """The port's copy of the config agrees with the reference's on every
    field it keeps, and on the derived properties."""
    for port, ref in ((get_config(ARCH), jax_chatglm.CONFIG),
                      (chatglm3_6b.reduced(), jax_chatglm.reduced())):
        for f in dataclasses.fields(ModelConfig):
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
        assert port.resolved_head_dim == ref.resolved_head_dim
        assert port.layer_kinds() == ref.layer_kinds()


@pytest.mark.parametrize("change,match", [
    # MoE and chunked attention are ported: with an unported field they
    # still raise, naming it
    (dict(n_experts=4, top_k=2, attn_logit_softcap=30.0), "softcap"),
    (dict(attn_chunk=8, global_every=4, mlp="relu"), "mlp='relu'"),
    (dict(attn_logit_softcap=30.0), "softcap"),
    (dict(mlp="relu"), "mlp='relu'"),
])
def test_unported_kinds_raise(change, match):
    cfg = dataclasses.replace(get_reduced(ARCH), **change)
    with pytest.raises(NotImplementedError, match=match):
        check_ported(cfg)
    with pytest.raises(NotImplementedError, match=match):
        Transformer(cfg, "cpu")


def test_params_from_jax_rejects_wrong_depth():
    jcfg, tcfg = _cfgs()
    np_params = jax.tree.map(np.asarray, T.init_params(jcfg, jax.random.PRNGKey(1)))
    with pytest.raises(ValueError, match="layers"):
        params_from_jax(np_params, dataclasses.replace(tcfg, n_layers=3))


def test_params_from_jax_bfloat16_bits():
    """bf16 reference params arrive bit-exact."""
    jcfg = jax_chatglm.reduced()
    np_params = jax.tree.map(np.asarray, T.init_params(jcfg, jax.random.PRNGKey(2)))
    state = params_from_jax(np_params, get_reduced(ARCH))
    assert state["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        state["layers.1.attn.wq"].float().numpy(),
        np_params["segments"]["seg0"]["pos0"]["attn"]["wq"][1].astype(np.float32))
    model = Transformer(get_reduced(ARCH), "cpu")
    model.load_state_dict(state)     # strict: the key sets agree


# ---- qwen2-7b: GQA 7:1 with QKV biases and rope_theta 1e6 ---------------------

QWEN = "qwen2-7b"


@pytest.fixture(scope="module")
def qwen_models():
    """qwen2-7b's reduced config (GQA 2:1 at test size) in fp32 on both
    sides, equal weights, biases and norm scales perturbed as above."""
    from repro.configs import qwen2_7b as jax_qwen
    jcfg = dataclasses.replace(jax_qwen.reduced(), param_dtype="float32")
    tcfg = dataclasses.replace(get_reduced(QWEN), param_dtype="float32")
    rng = np.random.default_rng(10)
    np_params = jax.tree.map(np.asarray,
                             T.init_params(jcfg, jax.random.PRNGKey(10)))

    def perturb(path, a):
        if path[-1].key in ("bq", "bk", "bv", "scale"):
            return (a + rng.normal(0.0, 0.5, a.shape)).astype(a.dtype)
        return a

    np_params = jax.tree_util.tree_map_with_path(perturb, np_params)
    model = Transformer(tcfg, "cpu")
    model.load_state_dict(params_from_jax(np_params, tcfg))
    return jax.tree.map(jnp.asarray, np_params), jcfg, model, tcfg


def test_qwen2_config_matches_reference():
    from repro.configs import qwen2_7b as jax_qwen
    from repro_torch.configs import qwen2_7b
    for port, ref in ((get_config(QWEN), jax_qwen.CONFIG),
                      (qwen2_7b.reduced(), jax_qwen.reduced())):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.layer_kinds() == ref.layer_kinds()
    cfg = get_config(QWEN)
    assert (cfg.n_heads // cfg.n_kv_heads, cfg.resolved_head_dim,
            cfg.qkv_bias, cfg.rope_theta) == (7, 128, True, 1e6)
    check_ported(cfg)


def test_qwen2_forward_matches_reference(qwen_models):
    params, jcfg, model, tcfg = qwen_models
    toks = np.random.default_rng(11).integers(0, tcfg.vocab, (2, 24))
    ref, _ = T.forward(params, jcfg, {"tokens": jnp.asarray(toks)})
    out = model(torch.from_numpy(toks))
    assert out.shape == (2, 24, tcfg.vocab)
    _close(out, ref)


def test_qwen2_prefill_and_decode_match_reference(qwen_models):
    params, jcfg, model, tcfg = qwen_models
    rng = np.random.default_rng(12)
    B, S, steps = 2, 12, 8
    toks = rng.integers(0, tcfg.vocab, (B, S))
    feed = rng.integers(0, tcfg.vocab, (steps, B, 1))
    lg, caches, _ = T.prefill(params, jcfg, {"tokens": jnp.asarray(toks)},
                              max_len=S + steps, cache_dtype=jnp.float32)
    out, cache = model.prefill(torch.from_numpy(toks), max_len=S + steps)
    _close(out, lg)
    step = jax.jit(lambda p, tok, pos, c: T.decode_step(p, jcfg, tok, pos, c))
    for i in range(steps):
        lg, caches = step(params, jnp.asarray(feed[i]), jnp.int32(S + i),
                          caches)
        out, cache = model.decode_step(torch.from_numpy(feed[i]), S + i,
                                       cache)
        _close(out, lg)
    ref_v = np.asarray(caches["seg0"]["pos0"]["attn"]["v"])
    port_v = torch.stack([c["v"] for c in cache.layers])
    np.testing.assert_allclose(port_v.numpy(), ref_v, atol=TOL, rtol=TOL)


def test_qwen2_generate_matches_reference_greedy_loop(qwen_models):
    """The port's ``generate`` against the reference's prefill and decode
    steps driven greedily: the same tokens and, within TOL, the same
    logits each token was chosen from."""
    from repro_torch.launch.serve import generate
    params, jcfg, model, tcfg = qwen_models
    B, S, new = 3, 10, 6
    toks = np.random.default_rng(13).integers(0, tcfg.vocab, (B, S))
    lg, caches, _ = T.prefill(params, jcfg, {"tokens": jnp.asarray(toks)},
                              max_len=S + new, cache_dtype=jnp.float32)
    cur = jnp.argmax(lg[:, 0], -1)[:, None]
    ref_toks, ref_lgs = [cur], [lg[:, 0]]
    for i in range(new - 1):
        lg, caches = T.decode_step(params, jcfg, cur, jnp.int32(S + i),
                                   caches)
        cur = jnp.argmax(lg[:, 0], -1)[:, None]
        ref_toks.append(cur)
        ref_lgs.append(lg[:, 0])
    out = generate(model, torch.from_numpy(toks), new)
    np.testing.assert_array_equal(out.tokens.numpy(),
                                  np.concatenate(ref_toks, 1))
    _close(out.logits, jnp.stack(ref_lgs, 1))


def test_qwen2_params_from_jax_bfloat16_bits_with_biases():
    """bf16 reference params, QKV biases included, arrive bit-exact."""
    from repro.configs import qwen2_7b as jax_qwen
    jcfg = jax_qwen.reduced()
    np_params = jax.tree.map(np.asarray,
                             T.init_params(jcfg, jax.random.PRNGKey(14)))
    state = params_from_jax(np_params, get_reduced(QWEN))
    attn = np_params["segments"]["seg0"]["pos0"]["attn"]
    for leaf in ("bq", "bk", "bv", "wk"):
        np.testing.assert_array_equal(
            state[f"layers.1.attn.{leaf}"].float().numpy(),
            attn[leaf][1].astype(np.float32))
    Transformer(get_reduced(QWEN), "cpu").load_state_dict(state)
