"""Reference params -> the port's ``Transformer`` state dict.

The reference keeps a dense decoder's params as a pytree whose layers are
stacked on a leading axis: ``segments/seg0/pos0/<leaf path>`` has shape
``(n_layers, ...)`` (``repro/models/transformer.py:init_params``).  The port
has one module per layer, so each stacked leaf is unstacked into
``layers.<i>.<leaf path>``.  Leaves arrive as numpy arrays (the tests convert
the JAX pytree with ``np.asarray``), so this module needs no JAX.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # ml_dtypes' bfloat16, bit-cast
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, object]:
    out: Dict[str, object] = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = val
    return out


def params_from_jax(np_params: Mapping, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """State dict for ``Transformer(cfg)`` from the reference's params (a
    nested dict of numpy arrays)."""
    segs = np_params["segments"]
    if list(segs) != ["seg0"] or list(segs["seg0"]) != ["pos0"]:
        raise NotImplementedError(
            "only single-segment dense decoders are ported; got segments "
            f"{ {s: list(p) for s, p in segs.items()} }")
    state = {"embed": _tensor(np_params["embed"]),
             "unembed": _tensor(np_params["unembed"]),
             "final_norm.scale": _tensor(np_params["final_norm"]["scale"])}
    for path, stacked in _flatten(segs["seg0"]["pos0"]).items():
        stacked = np.asarray(stacked)
        if stacked.shape[0] != cfg.n_layers:
            raise ValueError(f"{path}: {stacked.shape[0]} layers stacked, "
                             f"config has {cfg.n_layers}")
        for i in range(cfg.n_layers):
            state[f"layers.{i}.{path}"] = _tensor(stacked[i])
    return state
