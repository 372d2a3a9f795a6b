"""Reference params <-> the port's ``Transformer`` state dict.

The reference groups a model's layers into *segments*, maximal runs of a
repeated pattern of layer kinds (``segments``, a copy of
``repro/models/transformer.py:segments`` in the port's
``models/transformer.py``), and stacks each pattern
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
tests convert the JAX pytree with ``np.asarray``) or as tensors (a
checkpoint read by ``repro_torch.checkpoint``), so this module needs no
JAX.  ``params_to_jax`` is the inverse: it restacks a state dict (or
anything keyed like one: AdamW's moments, the error-feedback residuals)
into the reference's tree, so a checkpoint of the port's training state has
the reference's leaf names.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import re

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import check_ported, segments


def _tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach()
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
                if not isinstance(stacked, torch.Tensor):
                    stacked = np.asarray(stacked)
                if stacked.shape[0] != reps:
                    raise ValueError(
                        f"seg{si}/pos{pi}/{path}: {stacked.shape[0]} layers "
                        f"stacked, the config has {reps}")
                for r in range(reps):
                    i = offset + r * len(pattern) + pi
                    state[f"{prefix}{i}.{path}"] = _tensor(stacked[r])
        offset += reps * len(pattern)


_LAYER = re.compile(r"^(enc\.)?layers\.(\d+)\.(.+)$")


def _layouts(cfg: ModelConfig) -> Dict[str, List[Tuple[Tuple[str, ...], int]]]:
    """The segment layout of the decoder's (``layers.``) and the encoder's
    (``enc.layers.``) stacks."""
    out = {"": segments(cfg)}
    if cfg.is_encdec:
        out["enc."] = [(("attn_bidir",), cfg.n_enc_layers)]
    return out


def _slot(layout, i: int) -> Tuple[int, int, int]:
    """(segment, pattern position, repeat) of layer i."""
    offset = 0
    for si, (pattern, reps) in enumerate(layout):
        n = reps * len(pattern)
        if i < offset + n:
            r, pi = divmod(i - offset, len(pattern))
            return si, pi, r
        offset += n
    raise ValueError(f"layer {i} beyond the config's {offset} layers")


def _nest(tree: Dict, path: List[str], leaf) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


def params_to_jax(state: Mapping[str, torch.Tensor], cfg: ModelConfig) -> Dict:
    """The reference's params tree (nested dicts of tensors on the state's
    device: the stacked leaves new, the others the state's own tensors,
    detached) from a state dict of ``Transformer(cfg)``, or from any dict
    keyed like one: each layer's leaf ``[enc.]layers.<i>.<path>`` is
    stacked with the other repeats of its segment position into
    ``[enc/]segments/seg{s}/pos{p}/<path>``, the other leaves nested by
    their dotted names.  The inverse of ``params_from_jax``."""
    check_ported(cfg)
    layouts = _layouts(cfg)
    tree: Dict = {}
    stacks: Dict[Tuple[str, int, int, str], Dict[int, torch.Tensor]] = {}
    for name, t in state.items():
        m = _LAYER.match(name)
        if m is None:
            _nest(tree, name.split("."), t.detach())
            continue
        prefix, i, path = m.group(1) or "", int(m.group(2)), m.group(3)
        si, pi, r = _slot(layouts[prefix], i)
        stacks.setdefault((prefix, si, pi, path), {})[r] = t.detach()
    for (prefix, si, pi, path), reps in stacks.items():
        want = layouts[prefix][si][1]
        if sorted(reps) != list(range(want)):
            raise ValueError(f"{prefix}seg{si}/pos{pi}/{path}: repeats "
                             f"{sorted(reps)}, the config has {want}")
        keys = (["enc"] if prefix else []) + [
            "segments", f"seg{si}", f"pos{pi}"] + path.split(".")
        _nest(tree, keys, torch.stack([reps[r] for r in range(want)]))
    return tree


def decayed(state: Mapping[str, torch.Tensor]) -> Dict[str, bool]:
    """Whether the reference's AdamW decays each tensor: ``ndim >= 2`` of
    its own leaf, where a layer's tensor has one more (leading) dim, its
    segment's repeat axis."""
    return {name: t.ndim + (_LAYER.match(name) is not None) >= 2
            for name, t in state.items()}
