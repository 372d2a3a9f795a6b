"""The port's LayerNorm models against the JAX reference on the CPU:
stablelm-1.6b (partial RoPE, MHA), starcoder2-3b (the non-gated GELU MLP,
QKV biases, GQA) and whisper-small (encoder-decoder: frame embeddings
through a bidirectional encoder, decoder layers with cross attention,
learned positions, no RoPE).

The reduced configs run in fp32 on both sides (the reference's dense
attention rounds its probabilities to the dtype before P.V, the port's flash
kernel does not, so they agree tightly only in fp32).  Every bias and norm
scale is perturbed with numpy: at init they are 0 and 1, which would hide a
dropped LayerNorm bias, ``final_norm.bias`` or QKV bias.  Reference weights
reach the port through ``params_from_jax``; whisper's frames are drawn with
numpy and handed to both.

Tolerance for logits: 1e-4 absolute and relative, the other model tests'
(sums in another order and the port's online softmax: ~1e-5 at the logits).
"""
import dataclasses
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jax_common
from repro.models import transformer as T
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve
from repro_torch.launch.serve import generate
from repro_torch.models import common
from repro_torch.models.transformer import MLP, Transformer

TOL = 1e-4
ARCHS = ["stablelm-1.6b", "starcoder2-3b", "whisper-small"]
PERTURBED = ("bq", "bk", "bv", "scale", "bias")


def _ref_module(arch):
    return importlib.import_module(
        "repro.configs." + arch.replace("-", "_").replace(".", "_"))


def _cfgs(arch):
    return (dataclasses.replace(_ref_module(arch).reduced(),
                                param_dtype="float32"),
            dataclasses.replace(get_reduced(arch), param_dtype="float32"))


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    """(JAX params, reference cfg, port model, port cfg) on equal weights."""
    jcfg, tcfg = _cfgs(request.param)
    rng = np.random.default_rng(20)
    np_params = jax.tree.map(np.asarray,
                             T.init_params(jcfg, jax.random.PRNGKey(20)))

    def perturb(path, a):
        if path[-1].key in PERTURBED:
            return (a + rng.normal(0.0, 0.5, a.shape)).astype(a.dtype)
        return a

    np_params = jax.tree_util.tree_map_with_path(perturb, np_params)
    model = Transformer(tcfg, "cpu")
    model.load_state_dict(params_from_jax(np_params, tcfg))
    return jax.tree.map(jnp.asarray, np_params), jcfg, model, tcfg


def _frames(rng, cfg, B):
    if not cfg.is_encdec:
        return None
    return rng.normal(size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32)


def _ref_batch(toks, frames):
    batch = {"tokens": jnp.asarray(toks)}
    if frames is not None:
        batch["frames"] = jnp.asarray(frames)
    return batch


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    ref = _ref_module(arch)
    for port, want in ((get_config(arch), ref.CONFIG),
                       (get_reduced(arch), ref.reduced())):
        assert dataclasses.asdict(port) == dataclasses.asdict(want)
        assert port.layer_kinds() == want.layer_kinds()
    cfg = get_config(arch)
    assert cfg.norm == "layernorm"
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)
    assert heads == {"stablelm-1.6b": (32, 32, 64),
                     "starcoder2-3b": (24, 2, 128),
                     "whisper-small": (12, 12, 64)}[arch]


def test_forward_matches_reference(models):
    params, jcfg, model, tcfg = models
    rng = np.random.default_rng(21)
    toks = rng.integers(0, tcfg.vocab, (2, 24))
    frames = _frames(rng, tcfg, 2)
    ref, _ = T.forward(params, jcfg, _ref_batch(toks, frames))
    out = model(torch.from_numpy(toks), frames=_t(frames))
    assert out.shape == (2, 24, tcfg.vocab) and out.dtype == torch.float32
    _close(out, ref)


def test_prefill_and_decode_match_reference(models):
    """Prefill, then 8 decode steps on the same (random) tokens; the
    self-attention cache slot for slot, and whisper's cross K/V (projected
    once here) against the reference's encoder output times each layer's
    ``wk``/``wv``."""
    params, jcfg, model, tcfg = models
    rng = np.random.default_rng(22)
    B, S, steps = 2, 12, 8
    toks = rng.integers(0, tcfg.vocab, (B, S))
    feed = rng.integers(0, tcfg.vocab, (steps, B, 1))
    frames = _frames(rng, tcfg, B)
    lg, caches, enc_kv = T.prefill(params, jcfg, _ref_batch(toks, frames),
                                   max_len=S + steps, cache_dtype=jnp.float32)
    out, cache = model.prefill(torch.from_numpy(toks), max_len=S + steps,
                               frames=_t(frames))
    _close(out, lg)
    step = jax.jit(lambda p, tok, pos, c, e: T.decode_step(
        p, jcfg, tok, pos, c, enc_kv=e))
    for i in range(steps):
        lg, caches = step(params, jnp.asarray(feed[i]), jnp.int32(S + i),
                          caches, enc_kv)
        out, cache = model.decode_step(torch.from_numpy(feed[i]), S + i,
                                       cache)
        assert out.shape == (B, 1, tcfg.vocab)
        _close(out, lg)
    ref_attn = caches["seg0"]["pos0"]["attn"]
    for leaf in ("k", "v"):
        port = torch.stack([c[leaf] for c in cache.layers])
        np.testing.assert_allclose(port.numpy(), np.asarray(ref_attn[leaf]),
                                   atol=TOL, rtol=TOL)
    assert cache.length == S + steps
    if tcfg.is_encdec:
        enc_out = np.asarray(enc_kv[0])
        cross = params["segments"]["seg0"]["pos0"]["cross"]
        for i, c in enumerate(cache.layers):
            for leaf, w in (("cross_k", "wk"), ("cross_v", "wv")):
                want = (enc_out @ np.asarray(cross[w][i])).reshape(
                    c[leaf].shape)
                np.testing.assert_allclose(c[leaf].numpy(), want, atol=TOL,
                                           rtol=TOL)
    else:
        assert all("cross_k" not in c for c in cache.layers)


def test_generate_matches_reference_greedy_loop(models):
    """The port's ``generate`` against the reference's prefill and decode
    steps driven greedily: the same tokens and, within TOL, the same
    logits each token was chosen from."""
    params, jcfg, model, tcfg = models
    rng = np.random.default_rng(23)
    B, S, new = 3, 10, 6
    toks = rng.integers(0, tcfg.vocab, (B, S))
    frames = _frames(rng, tcfg, B)
    lg, caches, enc_kv = T.prefill(params, jcfg, _ref_batch(toks, frames),
                                   max_len=S + new, cache_dtype=jnp.float32)
    cur = jnp.argmax(lg[:, 0], -1)[:, None]
    ref_toks, ref_lgs = [cur], [lg[:, 0]]
    for i in range(new - 1):
        lg, caches = T.decode_step(params, jcfg, cur, jnp.int32(S + i),
                                   caches, enc_kv=enc_kv)
        cur = jnp.argmax(lg[:, 0], -1)[:, None]
        ref_toks.append(cur)
        ref_lgs.append(lg[:, 0])
    out = generate(model, torch.from_numpy(toks), new, frames=_t(frames))
    np.testing.assert_array_equal(out.tokens.numpy(),
                                  np.concatenate(ref_toks, 1))
    _close(out.logits, jnp.stack(ref_lgs, 1))


def test_encoder_matches_reference(models):
    params, jcfg, model, tcfg = models
    if not tcfg.is_encdec:
        assert not hasattr(model, "enc")
        return
    frames = _frames(np.random.default_rng(24), tcfg, 2)
    ref = T.encode(params, jcfg, jnp.asarray(frames))
    _close(model.enc(torch.from_numpy(frames)), ref)


def test_kernels_get_contiguous_tensors_and_no_rmsnorm(models, monkeypatch):
    """The flash wrapper refuses non-contiguous tensors on the card, which
    the plain CPU path would accept: check what the model hands it, and how
    often (a layer's attention once; whisper's encoder layers once, in the
    prefill, and its decoder layers twice: self and cross).  A LayerNorm
    model calls no RMSNorm."""
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
                         generator=torch.Generator().manual_seed(25))
    frames = _t(_frames(np.random.default_rng(25), tcfg, 3))
    _, cache = model.prefill(toks, max_len=12, frames=frames)
    model.decode_step(toks[:, :1], 9, cache)
    L = tcfg.n_layers
    per_call = 2 * L if tcfg.is_encdec else L
    enc = tcfg.n_enc_layers if tcfg.is_encdec else 0
    assert calls == {"rmsnorm": 0, "flash_attention": enc + 2 * per_call}


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_bfloat16_bits(arch):
    """bf16 reference params arrive bit-exact: LayerNorm scales and biases,
    ``final_norm``, QKV biases, the MLP, and whisper's ``enc.*``,
    ``dec_pos_embed`` and cross attention; the key sets agree (strict
    load)."""
    jcfg = _ref_module(arch).reduced()
    rng = np.random.default_rng(26)
    np_params = jax.tree.map(np.asarray,
                             T.init_params(jcfg, jax.random.PRNGKey(26)))

    def perturb(path, a):        # zero biases would compare equal if dropped
        if path[-1].key in PERTURBED:
            return (a.astype(np.float32)
                    + rng.normal(0.0, 0.5, a.shape)).astype(a.dtype)
        return a

    np_params = jax.tree_util.tree_map_with_path(perturb, np_params)
    cfg = get_reduced(arch)
    state = params_from_jax(np_params, cfg)
    assert state["embed"].dtype == torch.bfloat16

    def same(key, ref):
        np.testing.assert_array_equal(state[key].float().numpy(),
                                      np.asarray(ref).astype(np.float32))

    layer = np_params["segments"]["seg0"]["pos0"]
    for norm in ("norm1", "norm2"):
        for leaf in ("scale", "bias"):
            same(f"layers.1.{norm}.{leaf}", layer[norm][leaf][1])
    same("final_norm.bias", np_params["final_norm"]["bias"])
    same("final_norm.scale", np_params["final_norm"]["scale"])
    same("layers.1.mlp.w_up", layer["mlp"]["w_up"][1])
    assert ("layers.0.mlp.w_gate" in state) == (cfg.mlp != "gelu")
    if cfg.qkv_bias:
        for leaf in ("bq", "bk", "bv"):
            same(f"layers.1.attn.{leaf}", layer["attn"][leaf][1])
    if cfg.is_encdec:
        enc = np_params["enc"]
        same("dec_pos_embed", np_params["dec_pos_embed"])
        same("enc.pos_embed", enc["pos_embed"])
        same("enc.final_norm.bias", enc["final_norm"]["bias"])
        enc_layer = enc["segments"]["seg0"]["pos0"]
        same("enc.layers.1.attn.wq", enc_layer["attn"]["wq"][1])
        same("enc.layers.1.norm1.bias", enc_layer["norm1"]["bias"][1])
        for leaf in ("wq", "wk", "wv", "wo"):
            same(f"layers.1.cross.{leaf}", layer["cross"][leaf][1])
        same("layers.1.norm_cross.bias", layer["norm_cross"]["bias"][1])
    Transformer(cfg, "cpu").load_state_dict(state)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    rng = np.random.default_rng(27)
    x = jnp.asarray(rng.normal(size=(3, 5, 64)) * 3 + 1,
                    jnp.float32).astype(dtype)
    p = {"scale": jnp.asarray(rng.normal(size=(64,)) + 1.0,
                              jnp.float32).astype(dtype),
         "bias": jnp.asarray(rng.normal(size=(64,)),
                             jnp.float32).astype(dtype)}
    ref = jax_common.layernorm(p, x)
    conv = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(  # noqa: E731
        getattr(torch, dtype))
    out = common.layernorm(conv(p["scale"]), conv(p["bias"]), conv(x))
    assert out.dtype == getattr(torch, dtype)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_reference(dtype):
    """The non-gated branch: gelu_tanh(x @ w_up) @ w_down, no ``w_gate``."""
    jcfg = dataclasses.replace(_ref_module("starcoder2-3b").reduced(),
                               param_dtype=dtype)
    tcfg = dataclasses.replace(get_reduced("starcoder2-3b"),
                               param_dtype=dtype)
    p = T._mlp_init(jax.random.PRNGKey(28), jcfg, getattr(jnp, dtype))
    x = jnp.asarray(np.random.default_rng(28).normal(size=(2, 5, 64)),
                    jnp.float32).astype(dtype)
    ref = T._mlp_apply(p, x, jcfg)
    mlp = MLP(tcfg, getattr(torch, dtype), "cpu", torch.Generator())
    assert sorted(n for n, _ in mlp.named_parameters()) == ["w_down", "w_up"]
    conv = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(  # noqa: E731
        getattr(torch, dtype))
    mlp.load_state_dict({k: conv(v) for k, v in p.items()})
    out = mlp(conv(x))
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


def test_frames_are_validated():
    """A config without an encoder refuses frames; an encoder-decoder
    requires them, (B, T, d) with T <= enc_seq."""
    plain = Transformer(get_reduced("starcoder2-3b"), "cpu")
    toks = torch.zeros(2, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="takes no frames"):
        plain(toks, frames=torch.zeros(2, 3, 64))
    cfg = get_reduced("whisper-small")
    whisper = Transformer(cfg, "cpu")
    with pytest.raises(ValueError, match="needs frames"):
        whisper.prefill(toks, max_len=6)
    for bad in ((1, cfg.enc_seq, cfg.d_model), (2, cfg.enc_seq + 1, cfg.d_model),
                (2, cfg.enc_seq, cfg.d_model + 1)):
        with pytest.raises(ValueError, match="frames"):
            whisper(toks, frames=torch.zeros(bad))
    # fewer frames than enc_seq: pos_embed[:T], as the reference
    assert whisper(toks, frames=torch.zeros(2, 5, cfg.d_model)).shape == \
        (2, 4, cfg.vocab)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(capsys, arch):
    summary = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "8", "--tokens",
                          "3", "--layers", "1"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["arch"] == arch and printed["layers"] == 1
    assert printed["enc_frames"] == (get_reduced(arch).enc_seq
                                     if arch == "whisper-small" else 0)
    assert summary["device"] == "cpu" and summary["peak_mem_gb"] is None


def test_cross_attention_takes_no_kv_biases():
    """With QKV biases (whisper has none; the rule is the reference's), cross
    attention adds ``bq`` to Q but projects K and V from the encoder states
    without ``bk``/``bv``; the decoder's self-attention adds all three."""
    jcfg, tcfg = (dataclasses.replace(c, qkv_bias=True)
                  for c in _cfgs("whisper-small"))
    rng = np.random.default_rng(29)
    np_params = jax.tree.map(np.asarray,
                             T.init_params(jcfg, jax.random.PRNGKey(29)))
    np_params = jax.tree_util.tree_map_with_path(
        lambda path, a: (a + rng.normal(0.0, 0.5, a.shape)).astype(a.dtype)
        if path[-1].key in PERTURBED else a, np_params)
    model = Transformer(tcfg, "cpu")
    model.load_state_dict(params_from_jax(np_params, tcfg))
    toks = rng.integers(0, tcfg.vocab, (2, 9))
    frames = _frames(rng, tcfg, 2)
    ref, _ = T.forward(jax.tree.map(jnp.asarray, np_params), jcfg,
                       _ref_batch(toks, frames))
    _close(model(torch.from_numpy(toks), frames=_t(frames)), ref)
