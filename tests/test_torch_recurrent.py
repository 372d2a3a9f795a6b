"""The port's recurrentgemma-2b and falcon-mamba-7b paths against the JAX
reference on the CPU: the RG-LRU and Mamba blocks, the sliding-window
attention with its rolling cache, GeGLU, tied embeddings, the conversion of
multi-segment reference params, and the configs.

Models run reduced and in fp32 on both sides (the reference's dense
attention rounds its probabilities to the dtype, the port's flash kernel
does not).  recurrentgemma runs 5 layers, two segments ((rglru, rglru,
attn_local) x 1 + (rglru, rglru)) as the full 26 = 8 * 3 + 2 do; its
attention window of 8 gives a rolling buffer of 16 slots, so a prompt of
20 tokens is longer than the buffer and decode wraps it.  The norm scales
and the b_a, b_i, conv_b and d_skip params are perturbed with numpy: at
init they are 1 or 0, which would hide a scale or bias bug.

Tolerance for logits and caches: 1e-4 absolute and relative (fp32; the port
scans sequentially where the reference uses an associative scan, and sums
in another order, ~1e-6 relative at the logits).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import falcon_mamba_7b as jax_falcon
from repro.configs import recurrentgemma_2b as jax_rg
from repro.models import mamba as jax_mamba
from repro.models import rglru as jax_rglru
from repro.models import transformer as T
from repro_torch.configs import falcon_mamba_7b, get_config, recurrentgemma_2b
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax, segments
from repro_torch.models import attention as attn_mod
from repro_torch.models import common
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models.mamba import Mamba, causal_conv
from repro_torch.models.rglru import RGLRU
from repro_torch.models.transformer import Transformer

TOL = 1e-4
ARCHS = {"recurrentgemma-2b": (jax_rg, recurrentgemma_2b, 5),
         "falcon-mamba-7b": (jax_falcon, falcon_mamba_7b, 2)}
PERTURBED = ("scale", "b_a", "b_i", "conv_b", "d_skip")


def _cfgs(arch, dtype="float32"):
    jmod, tmod, layers = ARCHS[arch]
    return (dataclasses.replace(jmod.reduced(), param_dtype=dtype,
                                n_layers=layers),
            dataclasses.replace(tmod.reduced(), param_dtype=dtype,
                                n_layers=layers))


def _perturb(np_params, seed):
    rng = np.random.default_rng(seed)

    def f(path, a):
        if path[-1].key in PERTURBED:
            return (a + rng.normal(0.0, 0.5, a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(f, np_params)


@pytest.fixture(scope="module", params=list(ARCHS))
def models(request):
    """(JAX params, reference cfg, port model, port cfg) on equal weights."""
    jcfg, tcfg = _cfgs(request.param)
    np_params = _perturb(jax.tree.map(
        np.asarray, T.init_params(jcfg, jax.random.PRNGKey(0))), 0)
    model = Transformer(tcfg, "cpu")
    model.load_state_dict(params_from_jax(np_params, tcfg))
    return jax.tree.map(jnp.asarray, np_params), jcfg, model, tcfg


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               atol=TOL, rtol=TOL)


def _layer_index(cfg):
    """(segment, pattern position, repeat) of each layer, in order."""
    out = []
    for si, (pattern, reps) in enumerate(segments(cfg)):
        out += [(si, pi, r) for r in range(reps) for pi in range(len(pattern))]
    return out


def test_forward_matches_reference(models):
    params, jcfg, model, tcfg = models
    toks = np.random.default_rng(1).integers(0, tcfg.vocab, (2, 24))
    ref, _ = T.forward(params, jcfg, {"tokens": jnp.asarray(toks)})
    out = model(torch.from_numpy(toks))
    assert out.shape == (2, 24, tcfg.vocab) and out.dtype == torch.float32
    _close(out, ref)
    _close(model(torch.from_numpy(toks), last=5), ref[:, -5:])


def test_prefill_and_decode_match_reference(models):
    """A 20-token prompt (longer than recurrentgemma's 16-slot buffer),
    then 8 decode steps on the same random tokens; at the end every cache
    (K/V and key positions, RG-LRU state, SSM state, conv history) holds
    what the reference's holds."""
    params, jcfg, model, tcfg = models
    rng = np.random.default_rng(2)
    B, S, steps = 2, 20, 8
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
    assert cache.length == S + steps
    kinds = tcfg.layer_kinds()
    for i, (si, pi, r) in enumerate(_layer_index(tcfg)):
        ref = caches[f"seg{si}"][f"pos{pi}"]
        ref = ref["attn"] if kinds[i].startswith("attn") else ref
        assert sorted(cache.layers[i]) == sorted(ref), kinds[i]
        for name, t in cache.layers[i].items():
            if name == "kpos":
                np.testing.assert_array_equal(t.numpy(), np.asarray(ref[name][r]))
            else:
                _close(t, ref[name][r])
    if "attn_local" in kinds:     # the buffer wrapped: L = 16 < S + steps
        kpos = cache.layers[kinds.index("attn_local")]["kpos"]
        assert kpos.shape == (16,) and int(kpos.max()) == S + steps - 1


def test_decode_rejects_multi_token_calls_after_the_start(models):
    _, _, model, tcfg = models
    _, cache = model.prefill(torch.zeros(1, 4, dtype=torch.long), max_len=8)
    with pytest.raises(ValueError, match="position"):
        model.layers[0](torch.zeros(1, 2, tcfg.d_model), 4, cache.layers[0])


def test_model_feeds_kernels_contiguous_tensors(models, monkeypatch):
    """On the card the kernel wrappers refuse non-contiguous tensors, which
    the plain CPU path would accept: check what the model hands them, and
    how often.  Per forward: two norms a layer (one in the ssm family) plus
    the final one, one attention per attention layer; one gated RG-LRU call
    per RG-LRU layer in every call, decode included; one Mamba scan per
    Mamba layer in a multi-token call only (its decode is plain torch)."""
    _, _, model, tcfg = models
    calls = {"rmsnorm": 0, "flash_attention": 0, "rglru_gated": 0,
             "mamba_scan": 0}

    def spy(mod, name, key):
        fn = getattr(mod, name)

        def wrapped(*args, **kwargs):
            for t in list(args) + list(kwargs.values()):
                if isinstance(t, torch.Tensor):
                    assert t.is_contiguous(), f"{key} got a non-contiguous tensor"
            calls[key] += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(mod, name, wrapped)

    spy(common, "fused_rmsnorm", "rmsnorm")
    spy(attn_mod, "flash_attention", "flash_attention")
    spy(rglru_mod, "rglru_gated", "rglru_gated")
    spy(mamba_mod, "mamba_scan", "mamba_scan")
    toks = torch.randint(0, tcfg.vocab, (3, 9),
                         generator=torch.Generator().manual_seed(5))
    _, cache = model.prefill(toks, max_len=12)
    model.decode_step(toks[:, :1], 9, cache)
    model(toks)
    kinds = tcfg.layer_kinds()
    norms = len(kinds) * (1 if tcfg.family == "ssm" else 2) + 1
    assert calls == {"rmsnorm": 3 * norms,
                     "flash_attention": 3 * sum(k.startswith("attn")
                                                for k in kinds),
                     "rglru_gated": 3 * kinds.count("rglru"),
                     "mamba_scan": 2 * kinds.count("mamba")}


# ---- the recurrent blocks on their own ----

@pytest.mark.parametrize("kind", ["rglru", "mamba"])
def test_block_matches_reference(kind):
    """One block: a 13-token call from a zero state (the scan kernel's
    path), then 3 one-token calls continuing from the returned state and
    conv history (the decode path), against ``rglru_mix``/``mamba_mix``."""
    arch = "recurrentgemma-2b" if kind == "rglru" else "falcon-mamba-7b"
    jcfg, tcfg = _cfgs(arch)
    key = jax.random.PRNGKey(3)
    init, mix = ((jax_rglru.rglru_init, jax_rglru.rglru_mix)
                 if kind == "rglru" else
                 (jax_mamba.mamba_init, jax_mamba.mamba_mix))
    np_p = _perturb({kind: jax.tree.map(np.asarray,
                                        init(key, jcfg, jnp.float32))}, 4)
    block = (RGLRU if kind == "rglru" else Mamba)(tcfg, torch.float32, "cpu",
                                                 torch.Generator())
    block.load_state_dict({k: torch.from_numpy(v.copy())
                           for k, v in np_p[kind].items()})
    jp = jax.tree.map(jnp.asarray, np_p[kind])
    x = np.random.default_rng(5).normal(size=(2, 16, tcfg.d_model)
                                        ).astype(np.float32)
    ref, (st, hist) = mix(jp, jnp.asarray(x[:, :13]), jcfg, return_state=True)
    state = "h" if kind == "rglru" else "ssm"
    width = tcfg.rnn_width if kind == "rglru" else tcfg.d_inner
    shape = (2, width) + ((tcfg.ssm_state,) if kind == "mamba" else ())
    cache = {state: torch.zeros(shape),
             "conv": torch.zeros(2, tcfg.ssm_conv - 1, width)}
    _close(block(torch.from_numpy(x[:, :13]), 0, cache), ref)
    _close(cache[state], st)
    _close(cache["conv"], hist)
    for t in range(13, 16):
        ref, (st, hist) = mix(jp, jnp.asarray(x[:, t:t + 1]), jcfg, state=st,
                              conv_hist=hist, return_state=True)
        _close(block(torch.from_numpy(x[:, t:t + 1]), t, cache), ref)
        _close(cache[state], st)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_history", [False, True])
def test_causal_conv_matches_reference(dtype, with_history):
    """The K taps in the reference's order and dtype: bit for bit."""
    rng = np.random.default_rng(6)
    conv = lambda a: jnp.asarray(a, jnp.float32).astype(dtype)  # noqa: E731
    x, w, b = (conv(rng.normal(size=s)) for s in ((2, 9, 24), (4, 24), (24,)))
    hist = conv(rng.normal(size=(2, 3, 24))) if with_history else None
    ref = jax_mamba._causal_conv(x, w, b, hist)
    tt = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(  # noqa: E731
        getattr(torch, dtype))
    out = causal_conv(tt(x), tt(w), tt(b), None if hist is None else tt(hist))
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref, np.float32))


def test_init_follows_reference_scheme():
    """The port draws its own random weights in the reference's scheme: the
    fp32 params stay fp32 in a bf16 model, a_log = log(1..N), dt in
    [1e-3, 0.1], a^c in [0.9, 0.999], d_skip = 1, zero biases."""
    model = Transformer(get_config_reduced("falcon-mamba-7b"), "cpu")
    m = model.layers[0].mamba
    assert m.in_proj.dtype == torch.bfloat16
    assert m.dt_bias.dtype == m.a_log.dtype == m.d_skip.dtype == torch.float32
    torch.testing.assert_close(
        m.a_log, torch.log(torch.arange(1.0, 5.0)).repeat(m.a_log.shape[0], 1))
    dt = torch.nn.functional.softplus(m.dt_bias)
    assert bool(((dt >= 1e-3 * 0.999) & (dt <= 0.1 * 1.001)).all())
    assert torch.equal(m.d_skip, torch.ones_like(m.d_skip))
    model = Transformer(get_config_reduced("recurrentgemma-2b"), "cpu")
    r = model.layers[0].rglru
    lam = r.get_parameter("lambda")
    assert lam.dtype == r.b_a.dtype == r.b_i.dtype == torch.float32
    a_c = torch.exp(-8.0 * torch.nn.functional.softplus(lam))
    assert bool(((a_c >= 0.9 - 1e-5) & (a_c <= 0.999 + 1e-5)).all())
    assert not r.b_a.any() and not r.conv_b.any()
    assert not hasattr(model, "unembed")          # tied to the embedding


def get_config_reduced(arch) -> ModelConfig:
    return ARCHS[arch][1].reduced()


# ---- params and configs ----

def test_params_from_jax_multi_segment_bfloat16_bits():
    """bf16 reference params of two segments arrive bit-exact in layer
    order (seg0/pos{p} repeat r -> layer 3r + p; seg1 -> layers 3, 4), the
    fp32 leaves stay fp32, and tied embeddings give no ``unembed``."""
    jcfg, tcfg = _cfgs("recurrentgemma-2b", "bfloat16")
    jcfg = dataclasses.replace(jcfg, n_layers=8)
    tcfg = dataclasses.replace(tcfg, n_layers=8)
    np_params = jax.tree.map(np.asarray, T.init_params(jcfg, jax.random.PRNGKey(7)))
    state = params_from_jax(np_params, tcfg)
    assert "unembed" not in state
    segs = np_params["segments"]
    expect = {"layers.3.rglru.w_a": segs["seg0"]["pos0"]["rglru"]["w_a"][1],
              "layers.4.rglru.in_x": segs["seg0"]["pos1"]["rglru"]["in_x"][1],
              "layers.5.attn.wq": segs["seg0"]["pos2"]["attn"]["wq"][1],
              "layers.6.mlp.w_gate": segs["seg1"]["pos0"]["mlp"]["w_gate"][0],
              "layers.7.rglru.lambda": segs["seg1"]["pos1"]["rglru"]["lambda"][0]}
    for name, ref in expect.items():
        assert state[name].dtype == (torch.float32 if "lambda" in name
                                     else torch.bfloat16), name
        np.testing.assert_array_equal(state[name].float().numpy(),
                                      ref.astype(np.float32))
    model = Transformer(tcfg, "cpu")
    model.load_state_dict(state)     # strict: the key sets agree
    for name, t in model.state_dict().items():
        assert t.dtype == state[name].dtype, name


def test_params_from_jax_rejects_wrong_depth():
    jcfg, tcfg = _cfgs("recurrentgemma-2b")
    np_params = jax.tree.map(np.asarray, T.init_params(jcfg, jax.random.PRNGKey(8)))
    for n_layers, match in ((8, "layers stacked"), (4, "pattern"),
                            (3, "segments")):
        with pytest.raises(ValueError, match=match):
            params_from_jax(np_params,
                            dataclasses.replace(tcfg, n_layers=n_layers))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_config_matches_reference(arch):
    """The port's copy agrees with the reference's on every field it keeps,
    on the derived properties, and on the layer kinds."""
    jmod, tmod, _ = ARCHS[arch]
    for port, ref in ((get_config(arch), jmod.CONFIG),
                      (tmod.reduced(), jmod.reduced())):
        for f in dataclasses.fields(ModelConfig):
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
        for prop in ("resolved_head_dim", "rnn_width", "d_inner", "dt_rank"):
            assert getattr(port, prop) == getattr(ref, prop), prop
        assert port.layer_kinds() == ref.layer_kinds()


@pytest.mark.parametrize("arch,change", [
    ("recurrentgemma-2b", {}), ("recurrentgemma-2b", dict(n_layers=3)),
    ("recurrentgemma-2b", dict(n_layers=5)), ("falcon-mamba-7b", {}),
    ("chatglm3-6b", {}), ("chatglm3-6b", dict(attn_chunk=8, global_every=4,
                                              n_layers=10)),
])
def test_segments_match_reference(arch, change):
    from repro.configs import chatglm3_6b as jax_chatglm
    jmod = ARCHS[arch][0] if arch in ARCHS else jax_chatglm
    port = dataclasses.replace(get_config(arch), **change)
    assert segments(port) == T.segments(
        dataclasses.replace(jmod.CONFIG, **change))
