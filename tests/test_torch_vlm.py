"""The port's phi-3-vision-4.2b path (image-patch embeddings before the
prompt) against the JAX reference on the CPU.

Two configs, both fp32 on both sides: the reference's ``reduced()`` (head_dim
16) and a narrow one at phi-3-vision's own head_dim 96 (d_model 192, 2 MHA
heads, 2 layers), the head_dim the CUDA kernels gained for it.  Norm scales
are perturbed with numpy (at init they are 1, which would hide a scale bug).
Reference weights reach the port through ``params_from_jax``, ``img_proj``
included; the image embeddings are drawn with numpy and handed to both.

Tolerance for logits: 1e-4 absolute and relative, the other model tests'
(sums in another order and the port's online softmax: ~1e-5 at the logits).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import phi_3_vision_4_2b as jax_phi3v
from repro.models import transformer as T
from repro_torch.configs import get_config, get_reduced, phi_3_vision_4_2b
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve
from repro_torch.launch.serve import generate
from repro_torch.models.transformer import Transformer

TOL = 1e-4
ARCH = "phi-3-vision-4.2b"
# the narrow config at head_dim 96
D96 = dict(n_layers=2, d_model=192, n_heads=2, n_kv_heads=2, d_ff=256,
           vocab=128, img_tokens=8)
CFGS = ["reduced", "d96"]


def _cfgs(which):
    jcfg = jax_phi3v.reduced() if which == "reduced" else \
        dataclasses.replace(jax_phi3v.CONFIG, **D96)
    tcfg = get_reduced(ARCH) if which == "reduced" else \
        dataclasses.replace(get_config(ARCH), **D96)
    return (dataclasses.replace(jcfg, param_dtype="float32"),
            dataclasses.replace(tcfg, param_dtype="float32"))


@pytest.fixture(scope="module", params=CFGS)
def models(request):
    """(JAX params, reference cfg, port model, port cfg) on equal weights."""
    jcfg, tcfg = _cfgs(request.param)
    rng = np.random.default_rng(0)
    np_params = jax.tree.map(np.asarray,
                             T.init_params(jcfg, jax.random.PRNGKey(0)))

    def perturb(path, a):
        if path[-1].key == "scale":
            return (a + rng.normal(0.0, 0.5, a.shape)).astype(a.dtype)
        return a

    np_params = jax.tree_util.tree_map_with_path(perturb, np_params)
    model = Transformer(tcfg, "cpu")
    model.load_state_dict(params_from_jax(np_params, tcfg))
    return jax.tree.map(jnp.asarray, np_params), jcfg, model, tcfg


def _img(rng, B, N, d):
    return rng.normal(size=(B, N, d)).astype(np.float32)


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               atol=TOL, rtol=TOL)


def test_config_matches_reference():
    """The port's copy agrees with the reference's on every field; the
    narrow test config keeps the published head_dim of 96."""
    assert get_config(ARCH).resolved_head_dim == 96
    assert _cfgs("d96")[1].resolved_head_dim == 96
    for port, ref in ((get_config(ARCH), jax_phi3v.CONFIG),
                      (phi_3_vision_4_2b.reduced(), jax_phi3v.reduced())):
        for f in dataclasses.fields(ModelConfig):
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
        assert port.resolved_head_dim == ref.resolved_head_dim
        assert port.layer_kinds() == ref.layer_kinds()


def test_forward_with_images_matches_reference(models):
    params, jcfg, model, tcfg = models
    rng = np.random.default_rng(1)
    B, S, N = 2, 12, tcfg.img_tokens
    toks = rng.integers(0, tcfg.vocab, (B, S))
    img = _img(rng, B, N, tcfg.d_model)
    ref, _ = T.forward(params, jcfg, {"tokens": jnp.asarray(toks),
                                      "img_embeds": jnp.asarray(img)})
    out = model(torch.from_numpy(toks), img_embeds=torch.from_numpy(img))
    assert out.shape == (B, N + S, tcfg.vocab) and out.dtype == torch.float32
    _close(out, ref)
    last = model(torch.from_numpy(toks), last=3,
                 img_embeds=torch.from_numpy(img))
    torch.testing.assert_close(last, out[:, -3:], atol=1e-6, rtol=1e-6)


def test_prefill_and_decode_with_images_match_reference(models):
    """Prefill over N image + S text positions, then 6 decode steps from
    position N + S on the same (random) tokens; the caches agree slot for
    slot, image positions first."""
    params, jcfg, model, tcfg = models
    rng = np.random.default_rng(2)
    B, S, N, steps = 2, 10, tcfg.img_tokens, 6
    toks = rng.integers(0, tcfg.vocab, (B, S))
    img = _img(rng, B, N, tcfg.d_model)
    feed = rng.integers(0, tcfg.vocab, (steps, B, 1))
    max_len = N + S + steps
    lg, caches, _ = T.prefill(params, jcfg,
                              {"tokens": jnp.asarray(toks),
                               "img_embeds": jnp.asarray(img)},
                              max_len=max_len, cache_dtype=jnp.float32)
    out, cache = model.prefill(torch.from_numpy(toks), max_len=max_len,
                               img_embeds=torch.from_numpy(img))
    assert cache.length == N + S
    _close(out, lg)
    step = jax.jit(lambda p, tok, pos, c: T.decode_step(p, jcfg, tok, pos, c))
    for i in range(steps):
        pos = N + S + i
        lg, caches = step(params, jnp.asarray(feed[i]), jnp.int32(pos), caches)
        out, cache = model.decode_step(torch.from_numpy(feed[i]), pos, cache)
        _close(out, lg)
    for name in ("k", "v"):
        ref_kv = np.asarray(caches["seg0"]["pos0"]["attn"][name])
        port_kv = torch.stack([c[name] for c in cache.layers])
        np.testing.assert_allclose(port_kv.numpy(), ref_kv, atol=TOL,
                                   rtol=TOL)
    assert cache.length == max_len


def test_generate_with_images_matches_forward(models):
    """``serve.generate``'s decode logits equal the forward's over image +
    prompt + generated tokens at the same positions (fp32, 1e-5: the same
    arithmetic over a cache), each token the argmax of its logits."""
    _, _, model, tcfg = models
    rng = np.random.default_rng(3)
    B, S, G, N = 2, 9, 5, tcfg.img_tokens
    prompts = torch.from_numpy(rng.integers(0, tcfg.vocab, (B, S)))
    img = torch.from_numpy(_img(rng, B, N, tcfg.d_model))
    out = generate(model, prompts, G, img)
    assert out.tokens.shape == (B, G)
    assert torch.equal(out.tokens, out.logits.argmax(-1))
    full = model(torch.cat([prompts, out.tokens[:, :-1]], 1), img_embeds=img)
    torch.testing.assert_close(out.logits, full[:, N + S - 1:], atol=1e-5,
                               rtol=1e-5)


def test_image_embeddings_are_required_and_checked(models):
    _, _, model, tcfg = models
    toks = torch.zeros(2, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="needs img_embeds"):
        model(toks)
    with pytest.raises(ValueError, match="img_embeds"):
        model(toks, img_embeds=torch.zeros(3, 8, tcfg.d_model))
    with pytest.raises(ValueError, match="img_embeds"):
        model.prefill(toks, 20, img_embeds=torch.zeros(2, 8, tcfg.d_model + 1))
    text_only = Transformer(get_reduced("chatglm3-6b"), "cpu")
    with pytest.raises(ValueError, match="no image"):
        text_only(toks, img_embeds=torch.zeros(2, 8, 64))


def test_params_from_jax_carries_img_proj_bits():
    """bf16 reference params, ``img_proj`` included, arrive bit-exact, and
    the state dict loads strictly."""
    jcfg = jax_phi3v.reduced()
    np_params = jax.tree.map(np.asarray,
                             T.init_params(jcfg, jax.random.PRNGKey(2)))
    state = params_from_jax(np_params, get_reduced(ARCH))
    assert state["img_proj"].dtype == torch.bfloat16
    np.testing.assert_array_equal(state["img_proj"].float().numpy(),
                                  np_params["img_proj"].astype(np.float32))
    Transformer(get_reduced(ARCH), "cpu").load_state_dict(state)


def test_serve_cli_with_images_on_cpu(capsys):
    summary = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "8", "--tokens",
                          "3"])
    assert summary["img_tokens"] == 8 and summary["prompt_len"] == 8
    assert summary["arch"] == ARCH and summary["device"] == "cpu"
    assert capsys.readouterr().out.strip().endswith("}")
