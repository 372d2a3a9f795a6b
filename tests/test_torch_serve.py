"""Serving through the port on the CPU: greedy generation is consistent with
the full forward, entry points refuse to drop to the CPU on their own, and
the port loads neither JAX nor the reference package."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_reduced
from repro_torch.launch import serve
from repro_torch.launch.serve import generate
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models.transformer import Transformer
from repro_torch.search import SearchSession, SearchSpec, search

ROOT = Path(__file__).resolve().parents[1]
ARCH = "chatglm3-6b"
ARCHS = ["chatglm3-6b", "recurrentgemma-2b", "falcon-mamba-7b"]


def _model(dtype="float32", seed=0, arch=ARCH):
    cfg = dataclasses.replace(get_reduced(arch), param_dtype=dtype)
    return Transformer(cfg, device="cpu", seed=seed)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_forward(arch):
    """Each decode step's logits equal the full forward's at that position
    (fp32; 1e-5: the same arithmetic over a cache instead of a prompt), and
    each token is the argmax of its logits.  recurrentgemma's prompt of 20
    is longer than its rolling buffer of 16 slots."""
    model = _model(arch=arch)
    B, S, G = 3, 20, 6
    prompts = torch.randint(0, model.cfg.vocab, (B, S),
                            generator=torch.Generator().manual_seed(1))
    out = generate(model, prompts, G)
    assert out.tokens.shape == (B, G) and out.logits.shape == (B, G, model.cfg.vocab)
    assert torch.equal(out.tokens, out.logits.argmax(-1))
    full = model(torch.cat([prompts, out.tokens[:, :-1]], 1))
    torch.testing.assert_close(out.logits, full[:, S - 1:], atol=1e-5, rtol=1e-5)


def test_steps_match_model_methods():
    model = _model(seed=2)
    toks = torch.randint(0, model.cfg.vocab, (2, 5),
                         generator=torch.Generator().manual_seed(3))
    lg, cache = make_prefill_step(model, max_len=8)({"tokens": toks})
    lg2, _ = model.prefill(toks, max_len=8)
    assert torch.equal(lg, lg2)
    nxt = lg[:, 0].argmax(-1, keepdim=True)
    lg3, cache = make_decode_step(model)({"token": nxt, "pos": 5,
                                         "caches": cache})
    assert lg3.shape == (2, 1, model.cfg.vocab) and cache.length == 6


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_bfloat16_is_finite(arch):
    model = _model("bfloat16", arch=arch)
    prompts = torch.randint(0, model.cfg.vocab, (2, 7),
                            generator=torch.Generator().manual_seed(4))
    out = generate(model, prompts, 4)
    assert out.logits.dtype == torch.float32
    assert torch.isfinite(out.logits).all()


def test_entry_points_without_device_raise_when_no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Transformer(get_reduced(ARCH))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        search("vgg16", "simba", backend="ga")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SearchSession(SearchSpec(workload="vgg16")).run()
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(capsys, arch):
    summary = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "8", "--tokens",
                          "3", "--layers", "1"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["arch"] == arch and printed["layers"] == 1
    assert summary["device"] == "cpu" and summary["peak_mem_gb"] is None


_HYGIENE = r"""
import importlib, importlib.util, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_neither_jax_nor_reference():
    res = subprocess.run(
        [sys.executable, "-c", _HYGIENE, str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, timeout=120, check=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        cwd=ROOT)
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert "repro_torch.models.transformer" in out["modules"]
    assert "repro_torch.launch.serve" in out["modules"]
    assert "repro_torch.models.mamba" in out["modules"]
    assert "repro_torch.kernels.rglru_scan.ops" in out["modules"]
    assert "repro_torch.search" in out["modules"]
    assert "repro_torch.core.population" in out["modules"]
    assert "repro_torch.kernels.ga_labels.ops" in out["modules"]
    # the schedule service: imported (the CLI without running it)
    for name in ("repro_torch.__main__", "repro_torch.search.island",
                 "repro_torch.serve.scheduler", "repro_torch.serve.store",
                 "repro_torch.analysis.verify", "repro_torch.obs.collect"):
        assert name in out["modules"], name
    assert out["bad"] == []
