"""``repro_torch.ir.from_torch`` against the reference's ``from_jax``, on
the CPU.

Each case of the reference's ``TestFromJax`` (``tests/test_ir.py:501-746``)
has a PyTorch counterpart here, written op for op like the JAX function
(convolutions on NCHW operands, permutes where the JAX code uses NHWC
dimension numbers).  Where ``from_jax`` succeeds, ``from_torch`` must give
the same canonical JSON and fingerprint, and the reference's assertions
hold on the port's IR.  Two reference cases fail in the JAX package itself
(its walker knows ``pjit`` but jax 0.9 names the call ``jit``; ROADMAP C4),
so their counterparts are held to a hand-built GraphIR
(``test_trace_through_module_calls_and_nhwc``) and to a ``TraceError``
naming the op (``test_trace_rejects_unsupported_op``).  Then the
``nn.Module`` forms (``nn.Conv2d``, batch norm, ``nn.Linear``, adaptive
pooling, ``nn.Flatten``), chip_smoke.py's ``SmokeCNN`` (its fingerprint
and its search result pinned to the reference's, FROM_TORCH_RUN), and the
tracer's own refusals.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import lax
from torch import nn

import repro.ir as rir
from repro.ir.trace import TraceError as RefTraceError
from repro_torch import ir
from repro_torch.costmodel import SIMBA
from repro_torch.ir.trace import TraceError
from repro_torch.search import SearchSession, build_workload
from repro_torch.search.artifact import graph_fingerprint

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _zeros(*shapes):
    return (tuple(jnp.zeros(s) for s in shapes),
            tuple(torch.zeros(s) for s in shapes))


def _same_as_jax(jfn, tfn, shapes, name="traced_cnn"):
    """from_torch's IR, held equal to from_jax's (canonical JSON and
    fingerprint) on the same argument shapes."""
    jargs, targs = _zeros(*shapes)
    want = rir.from_jax(jfn, jargs, name=name)
    got = ir.from_torch(tfn, targs, name=name)
    assert got.canonical_json() == want.canonical_json()
    assert got.fingerprint() == want.fingerprint()
    return got


# ---- the reference's TestFromJax cases -------------------------------------------

def _tiny_jax(x, w1, w2, w3):
    y = lax.conv_general_dilated(x, w1, (1, 1), "SAME")
    y = jnp.maximum(y, 0.0)
    y = lax.reduce_window(y, -jnp.inf, lax.max,
                          (1, 1, 2, 2), (1, 1, 2, 2), "VALID")
    y = lax.conv_general_dilated(y, w2, (1, 1), "SAME")
    y = jnp.maximum(y, 0.0)
    y = jnp.mean(y, axis=(2, 3))
    return y.reshape(1, -1) @ w3


def _tiny_torch(x, w1, w2, w3):
    y = F.conv2d(x, w1, padding=1)
    y = torch.relu(y)
    y = F.max_pool2d(y, 2)
    y = F.conv2d(y, w2, padding="same")
    y = F.relu(y)
    y = y.mean((2, 3))
    return y.reshape(1, -1) @ w3


TINY = ((1, 3, 32, 32), (8, 3, 3, 3), (16, 8, 3, 3), (16, 10))


def test_trace_maps_ops_to_layer_kinds():
    gir = _same_as_jax(_tiny_jax, _tiny_torch, TINY, name="tiny")
    kinds = [n["kind"] for n in gir.nodes]
    assert kinds == ["input", "conv", "pool", "conv", "global_pool", "fc"]
    g = gir.build()
    g.validate()
    conv = g.layers[gir.nodes[1]["name"]]
    assert (conv.c, conv.h, conv.w, conv.m, conv.r) == (3, 32, 32, 8, 3)
    fc = g.layers[gir.nodes[-1]["name"]]
    assert (fc.c, fc.m) == (16, 10)


def test_trace_is_deterministic_and_searchable():
    _, args = _zeros(*TINY)
    g1, g2 = (ir.from_torch(_tiny_torch, args, name="t").build()
              for _ in range(2))
    assert graph_fingerprint(g1) == graph_fingerprint(g2)
    art = SearchSession.from_objects(g1, SIMBA, backend="exhaustive",
                                     device="cpu").run()
    assert art.best_fitness >= 1.0


def test_trace_depthwise_and_residual():
    def jblock(x, wdw, wpw):
        y = lax.conv_general_dilated(x, wdw, (1, 1), "SAME",
                                     feature_group_count=8)
        y = lax.conv_general_dilated(y, wpw, (1, 1), "SAME")
        return x + y

    def tblock(x, wdw, wpw):
        y = F.conv2d(x, wdw, padding=1, groups=8)
        y = F.conv2d(y, wpw)
        return x + y

    gir = _same_as_jax(jblock, tblock,
                       ((1, 8, 16, 16), (8, 1, 3, 3), (8, 8, 1, 1)),
                       name="res")
    assert [n["kind"] for n in gir.nodes] == ["input", "dwconv", "conv",
                                              "add"]
    add = gir.nodes[-1]
    assert set(add["inputs"]) == {gir.nodes[0]["name"],
                                  gir.nodes[2]["name"]}


def test_trace_through_module_calls_and_nhwc():
    """Counterpart of ``test_trace_through_jit_and_nhwc``, which fails in
    the reference (C4: its walker does not enter jax 0.9's ``jit``
    calls).  A conv inside a submodule call, NHWC in and out through
    permutes, stride 2 with the halo of JAX's 'SAME' (padding 1 on 16 ->
    8), then a folded ReLU: held to the GraphIR the reference's own test
    asserts, built by hand."""
    class Conv(nn.Module):
        def __init__(self):
            super().__init__()
            self.w = nn.Parameter(torch.zeros(4, 3, 3, 3))

        def forward(self, a):
            y = F.conv2d(a.permute(0, 3, 1, 2), self.w, stride=2,
                         padding=1)
            return y.permute(0, 2, 3, 1)

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = Conv()

        def forward(self, x):
            return F.relu(self.conv(x))

    gir = ir.from_torch(Net(), (torch.zeros(1, 16, 16, 3),), name="nhwc")
    want = ir.canonicalize(ir.GraphIR(name="nhwc", nodes=[
        {"name": "input_1", "kind": "input", "inputs": [], "m": 3,
         "p": 16, "q": 16},
        {"name": "conv_2", "kind": "conv", "inputs": ["input_1"], "c": 3,
         "h": 16, "w": 16, "m": 4, "p": 8, "q": 8, "r": 3, "s": 3,
         "stride": [2, 2], "padding": [1, 1], "dilation": [1, 1],
         "groups": 1}], outputs=["conv_2"]))
    assert gir.canonical_json() == want.canonical_json()
    assert [n["kind"] for n in gir.nodes] == ["input", "conv"]
    conv = gir.nodes[1]
    assert (conv["c"], conv["h"], conv["w"]) == (3, 16, 16)
    assert (conv["m"], conv["p"], conv["q"]) == (4, 8, 8)
    assert conv["stride"] == [2, 2]


def test_trace_squeeze_excite_keeps_the_branch():
    """y * se(y) with se broadcasting from (1,C,1,1) is a real mul layer:
    the SE branch must not be silently dead-eliminated."""
    def jse(x, w, wfc1, wfc2):
        y = lax.conv_general_dilated(x, w, (1, 1), "SAME")
        s = jnp.mean(y, axis=(2, 3))
        s = jax.nn.sigmoid((s @ wfc1) @ wfc2)
        return y * s.reshape(1, -1, 1, 1)

    def tse(x, w, wfc1, wfc2):
        y = F.conv2d(x, w, padding=1)
        s = y.mean((2, 3))
        s = torch.sigmoid((s @ wfc1) @ wfc2)
        return y * s.reshape(1, -1, 1, 1)

    gir = _same_as_jax(jse, tse, ((1, 4, 8, 8), (8, 4, 3, 3), (8, 2),
                                  (2, 8)), name="se")
    assert [n["kind"] for n in gir.nodes] == ["input", "conv",
                                              "global_pool", "fc", "fc",
                                              "mul"]
    mul = gir.nodes[-1]
    assert len(mul["inputs"]) == 2
    assert (mul["c"], mul["h"], mul["w"]) == (8, 8, 8)


def test_trace_1d_pool_is_not_squared():
    def jf(x):
        return lax.reduce_window(x, -jnp.inf, lax.max,
                                 (1, 1, 1, 2), (1, 1, 1, 2), "VALID")

    def tf(x):
        return F.max_pool2d(x, (1, 2), (1, 2))

    gir = _same_as_jax(jf, tf, ((1, 8, 32, 32),), name="pool1d")
    pool = gir.nodes[-1]
    assert (pool["r"], pool["s"]) == (1, 2)
    assert (pool["p"], pool["q"]) == (32, 16)
    assert pool["stride"] == [1, 2]


def test_trace_rejects_activation_x_activation_matmul():
    def jattn(x, wq, wk):
        a = lax.conv_general_dilated(x, wq, (1, 1), "SAME")
        b = lax.conv_general_dilated(x, wk, (1, 1), "SAME")
        return a.reshape(4, -1) @ b.reshape(-1, 4)

    def tattn(x, wq, wk):
        a = F.conv2d(x, wq)
        b = F.conv2d(x, wk)
        return a.reshape(4, -1) @ b.reshape(-1, 4)

    jargs, targs = _zeros((1, 3, 8, 8), (4, 3, 1, 1), (4, 3, 1, 1))
    with pytest.raises(RefTraceError, match="two traced"):
        rir.from_jax(jattn, jargs)
    with pytest.raises(TraceError, match="two traced activations"):
        ir.from_torch(tattn, targs)


def test_trace_nhwc_global_pool_and_concat():
    dn = ("NHWC", "HWIO", "NHWC")

    def jf(x, w1, w2):
        a = lax.conv_general_dilated(x, w1, (1, 1), "SAME",
                                     dimension_numbers=dn)
        b = lax.conv_general_dilated(x, w2, (1, 1), "SAME",
                                     dimension_numbers=dn)
        y = lax.concatenate([a, b], dimension=3)
        return jnp.mean(y, axis=(1, 2))

    def tf(x, w1, w2):
        xc = x.permute(0, 3, 1, 2)
        a = F.conv2d(xc, w1.permute(3, 2, 0, 1), padding=1)
        b = F.conv2d(xc, w2.permute(3, 2, 0, 1), padding=1)
        y = torch.cat([a.permute(0, 2, 3, 1), b.permute(0, 2, 3, 1)], 3)
        return y.mean((1, 2))

    shapes = ((1, 8, 8, 3), (3, 3, 3, 4), (3, 3, 3, 4))
    gir = _same_as_jax(jf, tf, shapes, name="nhwc_cat")
    assert [n["kind"] for n in gir.nodes] == ["input", "conv", "conv",
                                              "concat", "global_pool"]
    cat = gir.nodes[3]
    assert (cat["c"], cat["m"]) == (8, 8)
    gp = gir.nodes[4]
    assert (gp["c"], gp["h"], gp["w"]) == (8, 8, 8)

    def tg(x, w1, w2):
        xc = x.permute(0, 3, 1, 2)
        a = F.conv2d(xc, w1.permute(3, 2, 0, 1), padding=1)
        b = F.conv2d(xc, w2.permute(3, 2, 0, 1), padding=1)
        return torch.cat([a.permute(0, 2, 3, 1), b.permute(0, 2, 3, 1)], 1)

    with pytest.raises(TraceError, match="feature-dim"):
        ir.from_torch(tg, _zeros(*shapes)[1])


def test_trace_same_padding_on_even_input_keeps_halo():
    """JAX's 'SAME' stride 2 on an even input pads (0, 1); the symmetric
    Layer.padding keeps the halo (1), as PyTorch's padding=1 writes it,
    for convs and pools alike."""
    def jf(x, w):
        y = lax.conv_general_dilated(x, w, (2, 2), "SAME")
        return lax.reduce_window(y, -jnp.inf, lax.max,
                                 (1, 1, 3, 3), (1, 1, 2, 2), "SAME")

    def tf(x, w):
        y = F.conv2d(x, w, stride=2, padding=1)
        return F.max_pool2d(y, 3, 2, padding=1)

    gir = _same_as_jax(jf, tf, ((1, 3, 32, 32), (8, 3, 3, 3)))
    conv, pool = gir.nodes[-2], gir.nodes[-1]
    assert conv["padding"] == [1, 1]
    assert (conv["p"], conv["q"]) == (16, 16)
    assert pool["padding"] == [1, 1]
    assert (pool["p"], pool["q"]) == (8, 8)


def test_trace_raw_nhwc_pool_promotes_correct_channels():
    """Pooling an input that never went through a conv promotes it with
    the channels of the layout it is pooled in."""
    def jf(x):
        return lax.reduce_window(x, -jnp.inf, lax.max,
                                 (1, 2, 2, 1), (1, 2, 2, 1), "VALID")

    def tf(x):
        return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)

    gir = _same_as_jax(jf, tf, ((1, 32, 32, 8),), name="rawpool")
    inp, pool = gir.nodes
    assert (inp["m"], inp["p"], inp["q"]) == (8, 32, 32)
    assert (pool["c"], pool["h"], pool["w"]) == (8, 32, 32)
    assert (pool["m"], pool["p"], pool["q"]) == (8, 16, 16)


def test_trace_rejects_partial_spatial_reduction():
    def jf(x, w):
        return jnp.sum(lax.conv_general_dilated(x, w, (1, 1), "SAME"),
                       axis=2)

    def tf(x, w):
        return F.conv2d(x, w, padding=1).sum(2)

    jargs, targs = _zeros((1, 3, 8, 8), (4, 3, 3, 3))
    with pytest.raises(RefTraceError, match="part of the spatial"):
        rir.from_jax(jf, jargs)
    with pytest.raises(TraceError, match="part of the spatial"):
        ir.from_torch(tf, targs)


def test_trace_rejects_unsupported_op():
    """Counterpart of ``test_trace_rejects_unsupported_primitive``, which
    fails in the reference (C4: its jaxpr of ``jnp.sort`` holds a ``jit``
    call the walker does not enter, so the error names ``jit``): a sort
    raises a TraceError naming the op, as a method and as a function."""
    for fn in (lambda x: torch.sort(x, dim=-1)[0],
               lambda x: x.sort(-1).values):
        with pytest.raises(TraceError, match="unsupported op 'sort'"):
            ir.from_torch(fn, (torch.zeros(1, 4, 8, 8),))


def test_trace_rejects_batched_input():
    def jcnn(x, w):
        return lax.conv_general_dilated(x, w, (1, 1), "SAME")

    def tcnn(x, w):
        return F.conv2d(x, w, padding=1)

    jargs, targs = _zeros((4, 3, 8, 8), (8, 3, 3, 3))
    with pytest.raises(RefTraceError, match="batch"):
        rir.from_jax(jcnn, jargs)
    with pytest.raises(TraceError, match="batch"):
        ir.from_torch(tcnn, targs)


def test_traced_graph_round_trips_through_file(tmp_path):
    _, args = _zeros(*TINY)
    gir = ir.from_torch(_tiny_torch, args, name="tiny")
    path = tmp_path / "tiny.json"
    ir.save(gir, str(path))
    again = ir.load(str(path))
    assert again.fingerprint() == gir.fingerprint()
    assert build_workload(f"file:{path}").compiled().edge_pairs \
        == gir.build().compiled().edge_pairs


# ---- modules, and chip_smoke.py's SmokeCNN ----------------------------------------

class Classifier(nn.Module):
    """The tiny CNN as modules: conv with bias + batch norm + ReLU, max
    pooling, a 'same' conv, adaptive average pooling to 1, flatten and a
    linear head."""

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2d(3, 8, 3, padding=1), nn.BatchNorm2d(8), nn.ReLU(),
            nn.MaxPool2d(2), nn.Conv2d(8, 16, 3, padding="same"),
            nn.ReLU(inplace=True))
        self.pool = nn.AdaptiveAvgPool2d((1, 1))
        self.head = nn.Sequential(nn.Flatten(), nn.Dropout(0.1),
                                  nn.Linear(16, 10))

    def forward(self, x):
        return self.head(self.pool(self.features(x)))


def test_module_form_traces_like_the_function_form():
    """nn.Conv2d / BatchNorm2d / MaxPool2d / AdaptiveAvgPool2d / Flatten /
    Linear give the tiny CNN's graph: the same IR as ``from_jax`` of the
    JAX function (bias adds, batch norm and dropout fold)."""
    jargs, _ = _zeros(*TINY)
    want = rir.from_jax(_tiny_jax, jargs, name="tiny")
    got = ir.from_torch(Classifier().eval(), (torch.zeros(TINY[0]),),
                        name="tiny")
    assert got.canonical_json() == want.canonical_json()


def _smoke_jax(x, p):
    """chip_smoke.SmokeCNN written in JAX (batch norm as its eval-mode
    scale and shift)."""
    def conv(y, w, stride=1, pad=0, groups=1):
        return lax.conv_general_dilated(y, w, (stride, stride),
                                        [(pad, pad)] * 2,
                                        feature_group_count=groups)

    def bias(name):
        return p[name].reshape(1, -1, 1, 1)

    y = conv(x, p["stem"], 2, 1) * bias("bn_s") + bias("bn_b")
    y = jnp.maximum(y, 0.0)
    z = jnp.maximum(conv(y, p["dw"], 1, 1, 16) + bias("dw_b"), 0.0)
    z = conv(z, p["pw"]) + bias("pw_b")
    s = jnp.maximum(jnp.mean(z, axis=(2, 3)) @ p["se1"] + p["se1_b"], 0.0)
    s = jax.nn.sigmoid(s @ p["se2"] + p["se2_b"])
    y = y + z * s.reshape(1, -1, 1, 1)
    y = lax.reduce_window(y, -jnp.inf, lax.max,
                          (1, 1, 2, 2), (1, 1, 2, 2), "VALID")
    y = lax.concatenate([conv(y, p["a"]) + bias("a_b"),
                         conv(y, p["b"]) + bias("b_b")], 1)
    y = jnp.maximum(conv(y, p["head"], 1, 1) + bias("head_b"), 0.0)
    return jnp.mean(y, axis=(2, 3)).reshape(1, -1) @ p["fc"] + p["fc_b"]


def _smoke_params(m) -> dict:
    bn_s = m.bn.weight / torch.sqrt(m.bn.running_var + m.bn.eps)
    p = {"stem": m.stem.weight, "bn_s": bn_s,
         "bn_b": m.bn.bias - m.bn.running_mean * bn_s,
         "dw": m.dw.weight, "dw_b": m.dw.bias, "pw": m.pw.weight,
         "pw_b": m.pw.bias, "se1": m.se1.weight.T, "se1_b": m.se1.bias,
         "se2": m.se2.weight.T, "se2_b": m.se2.bias, "a": m.a.weight,
         "a_b": m.a.bias, "b": m.b.weight, "b_b": m.b.bias,
         "head": m.head.weight, "head_b": m.head.bias, "fc": m.fc.weight.T,
         "fc_b": m.fc.bias}
    return {k: jnp.asarray(v.detach().numpy()) for k, v in p.items()}


def test_smoke_cnn_is_its_jax_counterpart():
    """The JAX function the fingerprint golden comes from computes what
    SmokeCNN computes (fp32, 1e-5), so the two trace the same network."""
    torch.manual_seed(0)
    m = _chip_smoke().SmokeCNN().eval()
    x = np.random.default_rng(0).normal(size=(1, 3, 64, 64)).astype(
        np.float32)
    with torch.no_grad():
        out = m(torch.from_numpy(x)).numpy()
    ref = np.asarray(_smoke_jax(jnp.asarray(x), _smoke_params(m)))
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_chip_smoke_from_torch_golden_is_the_references():
    """FROM_TORCH_RUN: SmokeCNN's from_torch fingerprint is from_jax's of
    its JAX counterpart, its search result is the reference's on that
    graph, and the port's CPU search gives the reference's artifact."""
    from repro.costmodel import SIMBA as REF_SIMBA
    from repro.search import SearchSession as RefSession
    from tests.test_torch_ga_search import _comparable
    cs = _chip_smoke()
    run = cs.FROM_TORCH_RUN
    m = cs.SmokeCNN().eval()
    got = ir.from_torch(m, (torch.zeros(run["input_shape"]),),
                        name="smoke_cnn")
    want = rir.from_jax(_smoke_jax, (jnp.zeros(run["input_shape"]),
                                     _smoke_params(m)), name="smoke_cnn")
    assert got.canonical_json() == want.canonical_json()
    assert got.fingerprint() == want.fingerprint() == run["fingerprint"]
    ref = RefSession.from_objects(want.build(), REF_SIMBA,
                                  **run["search"]).run()
    assert dict(genome_mask=ref.genome_mask, best_fitness=ref.best_fitness,
                evaluations=ref.evaluations) == run["golden"]
    mine = SearchSession.from_objects(got.build(), SIMBA, device="cpu",
                                      **run["search"]).run()
    assert _comparable(mine) == _comparable(ref)
    assert cs.FROM_TORCH_RUN["accelerator"] == SIMBA.name


# ---- the tracer's own refusals ----------------------------------------------------

@pytest.mark.parametrize("fn,match", [
    (lambda x: F.adaptive_avg_pool2d(F.conv2d(x, torch.ones(4, 3, 1, 1)),
                                     2), "adaptive pooling"),
    (lambda x: x * 0 + torch.ones(1), "constant"),
    (lambda x: F.conv2d(x, torch.ones(4, 3, 1, 1)) if x.sum() > 0 else x,
     "cannot trace"),
    (lambda x: F.conv1d(x[0], torch.ones(4, 3, 1)), "unsupported op"),
    (nn.Sequential(nn.Conv2d(3, 4, 1), nn.LayerNorm([4, 8, 8])),
     "unsupported module 'LayerNorm'"),
])
def test_unsupported_programs_raise_naming_why(fn, match):
    with pytest.raises(TraceError, match=match):
        ir.from_torch(fn, (torch.zeros(1, 3, 8, 8),))
