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

from typing import Dict, List, Mapping, Optional, Tuple

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


def params_from_jax(np_params: Mapping, cfg: ModelConfig,
                    mesh=None) -> Dict[str, torch.Tensor]:
    """State dict for ``Transformer(cfg)`` from the reference's params (a
    nested dict of numpy arrays); with ``mesh``, each tensor a DTensor of
    its parameter's spec there (``launch.steps.param_specs``), to load into
    a model on that mesh (``launch.steps.distribute_model``)."""
    state = _params_from_jax(np_params, cfg)
    if mesh is None:
        return state
    from repro_torch.launch.steps import param_specs
    from repro_torch.models.common import use_mesh
    from repro_torch.models.transformer import distribute
    with use_mesh(mesh):
        specs = param_specs(cfg, list(state))
    return {n: distribute(t, mesh, specs[n]) for n, t in state.items()}


def _params_from_jax(np_params: Mapping, cfg: ModelConfig
                     ) -> Dict[str, torch.Tensor]:
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


def reference_leaf(name: str, cfg: ModelConfig) -> Tuple[Tuple[str, ...],
                                                         Optional[int]]:
    """(the path of the reference leaf that holds the port's parameter (or
    cache entry) ``name``, the index on its stacked layer axis, or None for
    an unstacked leaf): ``layers.<i>.<path>`` is repeat r of position p of
    segment s, ``("segments", "seg<s>", "pos<p>", *path)`` at r; an
    encoder layer's under ``enc``; any other name is its dotted path."""
    m = _LAYER.match(name)
    if m is None:
        return tuple(name.split(".")), None
    prefix, i, path = m.group(1) or "", int(m.group(2)), m.group(3)
    si, pi, r = _slot(_layouts(cfg)[prefix], i)
    keys = (("enc",) if prefix else ()) + (
        "segments", f"seg{si}", f"pos{pi}") + tuple(path.split("."))
    return keys, r


def leaf_at(tree: Mapping, keys: Tuple[str, ...]):
    for k in keys:
        tree = tree[k]
    return tree


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
    stacks: Dict[Tuple[str, ...], Dict[int, torch.Tensor]] = {}
    for name, t in state.items():
        keys, r = reference_leaf(name, cfg)
        if r is None:
            _nest(tree, list(keys), t.detach())
        else:
            stacks.setdefault(keys, {})[r] = t.detach()
    for keys, reps in stacks.items():
        enc = keys[0] == "enc"
        want = layouts["enc." if enc else ""][int(keys[enc + 1][3:])][1]
        if sorted(reps) != list(range(want)):
            raise ValueError(f"{'/'.join(keys)}: repeats {sorted(reps)}, "
                             f"the config has {want}")
        _nest(tree, list(keys), torch.stack([reps[r] for r in range(want)]))
    return tree


def decayed(state: Mapping[str, torch.Tensor]) -> Dict[str, bool]:
    """Whether the reference's AdamW decays each tensor: ``ndim >= 2`` of
    its own leaf, where a layer's tensor has one more (leading) dim, its
    segment's repeat axis."""
    return {name: t.ndim + (_LAYER.match(name) is not None) >= 2
            for name, t in state.items()}
