"""Reference params -> the port's ``Transformer`` state dict.

The reference groups a model's layers into *segments*, maximal runs of a
repeated pattern of layer kinds (``segments`` below, a copy of
``repro/models/transformer.py:segments``), and stacks each pattern
position's params on a leading repeat axis: ``segments/seg{s}/pos{p}/<leaf
path>`` has shape ``(reps, ...)``.  Repeat r of position p of a segment is
layer ``offset + r * len(pattern) + p``, where ``offset`` counts the layers
of the segments before it.  The port has one module per layer, so each
stacked leaf is unstacked into ``layers.<i>.<leaf path>``.  With tied
embeddings there is no ``unembed``; an ``img_tokens`` config carries
``img_proj`` across as it is.  A MoE layer's ``moe/router`` (d, E; fp32 in
every model), ``moe/w_gate`` and ``moe/w_up`` (E, d, f), ``moe/w_down`` (E,
f, d) and ``moe/shared/*`` arrive by path as ``layers.<i>.moe.*``, each
leaf in its own dtype.  An ``is_encdec`` config also carries
``dec_pos_embed`` and the encoder: ``enc/pos_embed``, ``enc/final_norm``
and its layers, stacked as one segment of ``n_enc_layers`` bidirectional
layers (``enc/segments/seg0/pos0``), into ``enc.layers.<i>``.  Leaves arrive as numpy arrays (the
tests convert the JAX pytree with ``np.asarray``), so this module needs no
JAX.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import check_ported


def segments(cfg: ModelConfig) -> List[Tuple[Tuple[str, ...], int]]:
    """(pattern, reps) of each segment, in layer order: the pattern is the
    block pattern, llama4's ``global_every`` layers, or else a MoE
    interleave of ``moe_every`` layers (a multiple of ``moe_every`` in
    every case, so that a pattern position says whether a layer is MoE)."""
    kinds = list(cfg.layer_kinds())
    plen = 1
    if cfg.block_pattern or (cfg.attn_chunk and cfg.global_every):
        plen = len(cfg.block_pattern) or cfg.global_every
    elif cfg.n_experts and cfg.moe_every > 1:
        plen = cfg.moe_every
    if cfg.n_experts and plen % cfg.moe_every:
        raise ValueError(f"{cfg.name}: pattern length {plen} is not a "
                         f"multiple of moe_every={cfg.moe_every}")
    if plen > 1:
        reps = len(kinds) // plen
        segs = []
        if reps:
            segs.append((tuple(kinds[:plen]), reps))
        if len(kinds) % plen:
            segs.append((tuple(kinds[reps * plen:]), 1))
        return segs
    return [(tuple(kinds[:1]), len(kinds))]


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
    check_ported(cfg)
    state = {"embed": _tensor(np_params["embed"])}
    for path, leaf in _flatten(np_params["final_norm"], "final_norm.").items():
        state[path] = _tensor(leaf)
    if not cfg.tie_embeddings:
        state["unembed"] = _tensor(np_params["unembed"])
    if cfg.img_tokens:
        state["img_proj"] = _tensor(np_params["img_proj"])
    _unstack(state, "layers.", np_params["segments"], segments(cfg))
    if cfg.is_encdec:
        enc = np_params["enc"]
        state["dec_pos_embed"] = _tensor(np_params["dec_pos_embed"])
        state["enc.pos_embed"] = _tensor(enc["pos_embed"])
        for path, leaf in _flatten(enc["final_norm"],
                                   "enc.final_norm.").items():
            state[path] = _tensor(leaf)
        _unstack(state, "enc.layers.", enc["segments"],
                 [(("attn_bidir",), cfg.n_enc_layers)])
    return state


def _unstack(state: Dict[str, torch.Tensor], prefix: str, segs: Mapping,
             layout: List[Tuple[Tuple[str, ...], int]]) -> None:
    """Each stacked leaf of ``segs`` into ``<prefix><i>.<leaf path>``."""
    if sorted(segs) != [f"seg{si}" for si in range(len(layout))]:
        raise ValueError(f"segments {sorted(segs)} do not match the config's "
                         f"{len(layout)}")
    offset = 0
    for si, (pattern, reps) in enumerate(layout):
        seg = segs[f"seg{si}"]
        if sorted(seg) != sorted(f"pos{pi}" for pi in range(len(pattern))):
            raise ValueError(f"seg{si} holds {sorted(seg)}, the config's "
                             f"pattern {pattern}")
        for pi in range(len(pattern)):
            for path, stacked in _flatten(seg[f"pos{pi}"]).items():
                stacked = np.asarray(stacked)
                if stacked.shape[0] != reps:
                    raise ValueError(
                        f"seg{si}/pos{pi}/{path}: {stacked.shape[0]} layers "
                        f"stacked, the config has {reps}")
                for r in range(reps):
                    i = offset + r * len(pattern) + pi
                    state[f"{prefix}{i}.{path}"] = _tensor(stacked[r])
        offset += reps * len(pattern)
