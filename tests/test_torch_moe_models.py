"""The port's MoE models against the JAX reference on the CPU: dbrx-132b
(16 experts top-4 at full size, LayerNorm, GQA) and llama4-maverick-400b-
a17b (128 experts top-1 with a shared expert on every 2nd layer, chunked
attention with a rolling chunk buffer and 1-in-4 global layers).

The reduced configs run in fp32 on both sides, weights from the reference's
``init_params`` through ``params_from_jax``, every norm scale and bias
perturbed with numpy (at init they are 1 and 0, which would hide a dropped
one).  The prefill and decode are held against the reference's ``prefill``
and ``decode_step`` at the config's own capacity, drops included: capacity
depends on the tokens of a call, so a decode step of 2-3 tokens drops picks
that the prefill keeps, and only the reference's own steps show the same
drops; at ``capacity_factor=16`` (no drops, as ``tests/test_arch_smoke.py``
does) they are held against the reference's forward.

Tolerance for logits: 1e-4 absolute and relative, the other model tests'.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_reduced as ref_get_reduced
from repro.models import transformer as T
from repro_torch.configs import SERVED_ARCHS, get_config, get_reduced
from repro_torch.convert import params_from_jax, segments
from repro_torch.launch import serve
from repro_torch.launch.serve import generate
from repro_torch.models import attention as attn_mod
from repro_torch.models.moe import MoE, dispatch
from repro_torch.models.transformer import Transformer, check_ported

TOL = 1e-4
ARCHS = ["dbrx-132b", "llama4-maverick-400b-a17b"]
LLAMA4 = ARCHS[1]
PERTURBED = ("scale", "bias")


def _cfgs(arch, **change):
    return (dataclasses.replace(ref_get_reduced(arch),
                                param_dtype="float32", **change),
            dataclasses.replace(get_reduced(arch), param_dtype="float32",
                                **change))


def _np_params(jcfg, seed):
    rng = np.random.default_rng(seed)
    np_params = jax.tree.map(np.asarray,
                             T.init_params(jcfg, jax.random.PRNGKey(seed)))

    def perturb(path, a):
        if path[-1].key in PERTURBED:
            return (a.astype(np.float32)
                    + rng.normal(0.0, 0.5, a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(perturb, np_params)


def _load(arch, seed, **change):
    """(JAX params, reference cfg, port model, port cfg) on equal weights."""
    jcfg, tcfg = _cfgs(arch, **change)
    np_params = _np_params(jcfg, seed)
    model = Transformer(tcfg, "cpu")
    model.load_state_dict(params_from_jax(np_params, tcfg))
    return jax.tree.map(jnp.asarray, np_params), jcfg, model, tcfg


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    return _load(request.param, 40)


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               atol=TOL, rtol=TOL)


def _ref_loop(params, jcfg, toks, feed, max_len):
    """The reference's prefill, then one decode step per row of ``feed``
    (None: greedy); returns (logits of each step, tokens fed, caches)."""
    lg, caches, _ = T.prefill(params, jcfg, {"tokens": jnp.asarray(toks)},
                              max_len=max_len, cache_dtype=jnp.float32)
    S = toks.shape[1]
    out, fed = [lg[:, 0]], []
    for i in range(len(feed)):
        cur = (jnp.argmax(out[-1], -1)[:, None] if feed[i] is None
               else jnp.asarray(feed[i]))
        fed.append(cur)
        lg, caches = T.decode_step(params, jcfg, cur, jnp.int32(S + i),
                                   caches)
        out.append(lg[:, 0])
    return out, fed, caches


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    for port, want in ((get_config(arch), ref_get_config(arch)),
                       (get_reduced(arch), ref_get_reduced(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(want)
        assert port.layer_kinds() == want.layer_kinds()
        assert segments(port) == T.segments(want)
    cfg = get_config(arch)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
            cfg.n_experts, cfg.top_k, cfg.n_shared_experts, cfg.norm) == {
        "dbrx-132b": (48, 8, 128, 16, 4, 0, "layernorm"),
        LLAMA4: (40, 8, 128, 128, 1, 1, "rmsnorm")}[arch]
    assert arch in SERVED_ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layers_are_the_references(arch):
    """A MoE FFN where the reference's params hold ``moe`` (dbrx: every
    layer; llama4: layers 1 and 3), its router fp32 in a bf16 model; the
    chunked layers' attention gets the chunk, the global one none."""
    cfg = get_reduced(arch)
    ref = T.init_params(ref_get_reduced(arch), jax.random.PRNGKey(0))
    want = [False] * cfg.n_layers
    offset = 0
    for si, (pattern, reps) in enumerate(T.segments(ref_get_reduced(arch))):
        for pi in range(len(pattern)):
            for r in range(reps):
                want[offset + r * len(pattern) + pi] = \
                    "moe" in ref["segments"][f"seg{si}"][f"pos{pi}"]
        offset += reps * len(pattern)
    model = Transformer(cfg, "cpu")
    assert [hasattr(layer, "moe") for layer in model.layers] == want
    assert [not hasattr(layer, "moe") for layer in model.layers] == \
        [hasattr(layer, "mlp") for layer in model.layers]
    assert want == ([True, True] if arch == "dbrx-132b"
                    else [False, True, False, True])
    for layer in model.layers:
        if hasattr(layer, "moe"):
            assert layer.moe.router.dtype == torch.float32
            assert layer.moe.w_gate.dtype == torch.bfloat16
    assert [layer.attn.chunk for layer in model.layers] == (
        [0, 0] if arch == "dbrx-132b" else [8, 8, 8, 0])


def test_forward_matches_reference(models):
    params, jcfg, model, tcfg = models
    toks = np.random.default_rng(41).integers(0, tcfg.vocab, (2, 24))
    ref, _ = T.forward(params, jcfg, {"tokens": jnp.asarray(toks)})
    out = model(torch.from_numpy(toks))
    assert out.shape == (2, 24, tcfg.vocab) and out.dtype == torch.float32
    _close(out, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax(arch, dtype):
    """Every leaf arrives bit for bit and in its own dtype: the experts
    (E, d, f) and (E, f, d) in the param dtype, the router fp32 in both, the
    shared expert; the key sets agree (strict load)."""
    jcfg = dataclasses.replace(ref_get_reduced(arch), param_dtype=dtype)
    cfg = dataclasses.replace(get_reduced(arch), param_dtype=dtype)
    np_params = _np_params(jcfg, 42)
    state = params_from_jax(np_params, cfg)
    want_dt = getattr(torch, dtype)
    assert state["embed"].dtype == want_dt

    def same(key, ref):
        np.testing.assert_array_equal(state[key].float().numpy(),
                                      np.asarray(ref).astype(np.float32))

    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    moe_layers = [i for i in range(cfg.n_layers)
                  if f"layers.{i}.moe.router" in state]
    assert moe_layers == ([0, 1] if arch == "dbrx-132b" else [1, 3])
    for i in moe_layers:
        si, pi, r = (0, 0, i) if arch == "dbrx-132b" else (0, i, 0)
        ref = np_params["segments"][f"seg{si}"][f"pos{pi}"]["moe"]
        assert state[f"layers.{i}.moe.router"].dtype == torch.float32
        same(f"layers.{i}.moe.router", ref["router"][r])
        for leaf, shape in (("w_gate", (E, d, f)), ("w_up", (E, d, f)),
                            ("w_down", (E, f, d))):
            assert state[f"layers.{i}.moe.{leaf}"].shape == shape
            assert state[f"layers.{i}.moe.{leaf}"].dtype == want_dt
            same(f"layers.{i}.moe.{leaf}", ref[leaf][r])
        if cfg.n_shared_experts:
            for leaf in ("w_gate", "w_up", "w_down"):
                same(f"layers.{i}.moe.shared.{leaf}", ref["shared"][leaf][r])
    if arch == LLAMA4:
        same("layers.2.mlp.w_gate",
             np_params["segments"]["seg0"]["pos2"]["mlp"]["w_gate"][0])
        same("layers.3.norm2.scale",
             np_params["segments"]["seg0"]["pos3"]["norm2"]["scale"][0])
    else:
        same("layers.1.norm2.bias",
             np_params["segments"]["seg0"]["pos0"]["norm2"]["bias"][1])
    model = Transformer(cfg, "cpu")
    model.load_state_dict(state)
    assert model.layers[moe_layers[0]].moe.router.dtype == torch.float32


def test_generate_matches_reference_greedy_loop(models):
    """``generate`` against the reference's prefill and greedy decode steps
    at the config's own capacity (the decode steps of 3 tokens drop picks):
    the same tokens and, within TOL, the logits each was chosen from."""
    params, jcfg, model, tcfg = models
    B, S, new = 3, 10, 6
    toks = np.random.default_rng(43).integers(0, tcfg.vocab, (B, S))
    lgs, fed, _ = _ref_loop(params, jcfg, toks, [None] * (new - 1), S + new)
    cur = jnp.argmax(lgs[-1], -1)[:, None]
    out = generate(model, torch.from_numpy(toks), new)
    np.testing.assert_array_equal(out.tokens.numpy(),
                                  np.concatenate(fed + [cur], 1))
    _close(out.logits, jnp.stack(lgs, 1))


@pytest.mark.parametrize("capacity", ["reduced", "published"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference_with_drops(arch, capacity,
                                                       monkeypatch):
    """Prefill, then 8 decode steps of 3 tokens on the same random tokens,
    at the reduced config's capacity factor (2.0) and at the published one
    (1.25): step for step the reference's logits.  The counter shows the
    drops: at 1.25 both models drop picks; at 2.0 llama4 (top-1 of 4: a
    decode step has one slot an expert) does, and dbrx cannot (top-2 of 4:
    the capacity is N, and no expert gets more than N picks)."""
    cf = get_config(arch).capacity_factor if capacity == "published" \
        else get_reduced(arch).capacity_factor
    params, jcfg, model, tcfg = _load(arch, 44, capacity_factor=cf)
    for name in ("host_syncs", "kept", "dropped"):
        monkeypatch.setattr(dispatch, name, 0)
    rng = np.random.default_rng(44)
    B, S, steps = 3, 12, 8
    toks = rng.integers(0, tcfg.vocab, (B, S))
    feed = list(rng.integers(0, tcfg.vocab, (steps, B, 1)))
    lgs, _, _ = _ref_loop(params, jcfg, toks, feed, S + steps)
    out, cache = model.prefill(torch.from_numpy(toks), max_len=S + steps)
    _close(out[:, 0], lgs[0])
    for i in range(steps):
        out, cache = model.decode_step(torch.from_numpy(feed[i]), S + i,
                                       cache)
        _close(out[:, 0], lgs[i + 1])
    moe_layers = sum(hasattr(layer, "moe") for layer in model.layers)
    assert dispatch.host_syncs == moe_layers * (1 + steps)
    assert dispatch.kept + dispatch.dropped == \
        moe_layers * B * (S + steps) * tcfg.top_k
    if arch == "dbrx-132b" and capacity == "reduced":
        assert dispatch.dropped == 0
    else:
        assert dispatch.dropped > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_forward_without_drops(arch):
    """At capacity_factor 16 nothing is dropped, and prefill + decode give
    the reference's full-forward logits (``tests/test_arch_smoke.py``)."""
    params, jcfg, model, tcfg = _load(arch, 45, capacity_factor=16.0)
    B, S, steps = 2, 12, 2
    toks = np.random.default_rng(45).integers(0, tcfg.vocab, (B, S))
    ref, _ = T.forward(params, jcfg, {"tokens": jnp.asarray(toks)})
    pre = torch.from_numpy(toks[:, :S - steps])
    _, cache = model.prefill(pre, max_len=S + 4)
    for i in range(steps):
        p = S - steps + i
        lg, cache = model.decode_step(torch.from_numpy(toks[:, p:p + 1]), p,
                                      cache)
        _close(lg[:, 0], ref[:, p])


def test_long_prompt_fills_the_chunk_buffer_as_the_reference():
    """llama4's reduced chunked layers keep a rolling buffer of 8 slots: a
    prompt of 13 positions attends over its own K/V with the chunk mask and
    leaves its last 8 positions; after 4 decode steps the slots, their key
    positions and K/V equal the reference's cache, and the global layer's
    full cache likewise."""
    params, jcfg, model, tcfg = _load(LLAMA4, 46)
    rng = np.random.default_rng(46)
    B, S, steps = 2, 13, 4
    toks = rng.integers(0, tcfg.vocab, (B, S))
    feed = list(rng.integers(0, tcfg.vocab, (steps, B, 1)))
    _, cache = model.prefill(torch.from_numpy(toks), max_len=S + steps)
    _, _, ref = _ref_loop(params, jcfg, toks, [], S + steps)
    for i, kind in enumerate(tcfg.layer_kinds()):
        want = ref["seg0"][f"pos{i}"]["attn"]
        c = cache.layers[i]
        if kind == "attn_chunk":
            assert c["k"].shape[1] == 8
            np.testing.assert_array_equal(c["kpos"].numpy(),
                                          np.asarray(want["kpos"][0]))
            assert sorted(c["kpos"].tolist()) == list(range(S - 8, S))
        else:
            assert "kpos" not in c and c["k"].shape[1] == S + steps
        for leaf in ("k", "v"):
            np.testing.assert_allclose(c[leaf].numpy(),
                                       np.asarray(want[leaf][0]),
                                       atol=TOL, rtol=TOL)
    lgs, _, ref = _ref_loop(params, jcfg, toks, feed, S + steps)
    for i in range(steps):
        out, cache = model.decode_step(torch.from_numpy(feed[i]), S + i,
                                       cache)
        _close(out[:, 0], lgs[i + 1])
    for i in range(3):                   # the chunked layers, wrapped
        np.testing.assert_array_equal(
            cache.layers[i]["kpos"].numpy(),
            np.asarray(ref["seg0"][f"pos{i}"]["attn"]["kpos"][0]))
        np.testing.assert_allclose(
            cache.layers[i]["v"].numpy(),
            np.asarray(ref["seg0"][f"pos{i}"]["attn"]["v"][0]),
            atol=TOL, rtol=TOL)


def test_attention_gets_the_chunk_in_prefill_and_decode(monkeypatch):
    """The flash wrapper sees chunk 8 from the chunked layers and 0 from the
    global one, in the prefill and in a decode step, and the decode of a
    chunked layer passes its buffer's key positions."""
    calls = []

    def spy(q, k, v, **kw):
        calls.append((q.shape[1], kw.get("chunk", 0),
                      kw.get("k_pos") is not None))
        return real(q, k, v, **kw)

    real = attn_mod.flash_attention
    monkeypatch.setattr(attn_mod, "flash_attention", spy)
    model = Transformer(get_reduced(LLAMA4), "cpu")
    toks = torch.randint(0, 128, (2, 11),
                         generator=torch.Generator().manual_seed(47))
    _, cache = model.prefill(toks, max_len=14)
    model.decode_step(toks[:, :1], 11, cache)
    assert calls == [(11, 8, False)] * 3 + [(11, 0, False)] \
        + [(1, 8, True)] * 3 + [(1, 0, False)]


@pytest.mark.parametrize("arch", ARCHS)
def test_check_ported_accepts_moe_and_still_refuses_the_softcap(arch):
    check_ported(get_config(arch))
    check_ported(get_reduced(arch))
    capped = dataclasses.replace(get_reduced(arch), attn_logit_softcap=30.0)
    with pytest.raises(NotImplementedError, match="softcap"):
        Transformer(capped, "cpu")
    assert isinstance(Transformer(get_reduced(arch), "cpu").layers[1].moe,
                      MoE)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(capsys, arch):
    summary = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "10", "--tokens",
                          "3", "--layers", "2"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["arch"] == arch and printed["layers"] == 2
    assert summary["device"] == "cpu" and summary["peak_mem_gb"] is None
