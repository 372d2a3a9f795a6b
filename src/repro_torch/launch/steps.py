"""Train, prefill and decode steps and their sharding specs
(counterpart: ``repro/launch/steps.py``).

Steps take the reference's batch dicts.  There is no ``jit``: PyTorch runs
eagerly, and the kernels launch on the current CUDA stream.

Sharding contracts, resolved against the mesh entered with ``use_mesh``:
params and optimizer state take the model's specs (``param_specs``: each
parameter its reference leaf's, without the stacked layer axis; TP over
``model``, FSDP over ``pod`` + ``data``), the train batch is split over
(pod, data), decode caches over (pod, data) or, with a batch of one, along
the sequence (``transformer.cache_specs``).  ``fit_spec`` drops an axis that does not
divide its dim, as the reference's in_shardings need.
``distribute_model`` turns a model's parameters into DTensors of those
specs, each rank keeping its slice of the tensor it built (no
communication); ``distribute_batch`` does the same for a batch.  The steps
then take such a model and batch as they take a plain one: the
model's ``shard`` constraints redistribute its activations, each kernel
runs on local shards (``local_map``), and the gradients are brought to their
parameter's placements before the optimizer, whose update runs on local
shards.  With no mesh nothing here makes a DTensor.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Mapping, Optional, Sequence

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.convert import decayed, leaf_at, reference_leaf
from repro_torch.models import transformer as T
from repro_torch.models.common import (BATCH, SEQ, PSpec, _mesh_sizes,
                                       dtype_of, fit_entries, full_value,
                                       pspec, use_mesh)
from repro_torch.models.transformer import Transformer, distribute, loss_fn
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               compress_decompress_ef, ef_state_init)


# ---- sharding specs ----

def fit_spec(spec: Sequence, shape, mesh) -> PSpec:
    """Drop spec axes that do not divide the corresponding dimension
    (whisper's odd 51865-vocab embedding, a batch-1 decode cell)."""
    return fit_entries(spec, tuple(shape), _mesh_sizes(mesh))


def fit_sharding_tree(mesh, spec_tree, shape_tree):
    """:func:`fit_spec` leaf-wise (the spec tree mirrors the shape tree,
    whose leaves have a ``shape``)."""
    if isinstance(spec_tree, PSpec):
        return fit_spec(spec_tree, shape_tree.shape, mesh)
    return {k: fit_sharding_tree(mesh, v, shape_tree[k])
            for k, v in spec_tree.items()}


def train_batch_pspecs(cfg: ModelConfig) -> Dict:
    specs = {"tokens": pspec(BATCH, SEQ), "labels": pspec(BATCH, SEQ)}
    if cfg.img_tokens:
        specs["img_embeds"] = pspec(BATCH, None, None)
    if cfg.is_encdec:
        specs["frames"] = pspec(BATCH, None, None)
    return specs


def opt_state_pspecs(cfg: ModelConfig) -> Dict:
    pp = T.param_pspecs(cfg)
    return {"mu": pp, "nu": pp, "step": pspec()}


def decode_input_pspecs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    shard_seq = shape.global_batch == 1
    specs = {"token": pspec(BATCH, None), "pos": pspec(),
             "caches": T.cache_pspecs(cfg, shard_seq=shard_seq)}
    if cfg.is_encdec:
        specs["enc_out"] = pspec(BATCH, None, None)
    return specs


def _unstacked(tree, name: str, cfg: ModelConfig) -> PSpec:
    keys, r = reference_leaf(name, cfg)
    spec = leaf_at(tree, keys)
    return spec if r is None else PSpec(*spec[1:])


def param_specs(cfg: ModelConfig, names: Sequence[str]) -> Dict[str, PSpec]:
    """The spec of each of the port's parameters ``names``: its reference
    leaf's (``convert.reference_leaf``), without the stacked layer axis."""
    tree = T.param_pspecs(cfg)
    return {n: _unstacked(tree, n, cfg) for n in names}


# ---- DTensors ----

@torch.no_grad()
def distribute_model(model: Transformer, mesh) -> Transformer:
    """Each parameter of ``model`` replaced, in place, by a DTensor of its
    spec on ``mesh`` (its ``requires_grad`` kept); returns the model."""
    with use_mesh(mesh):
        specs = param_specs(model.cfg,
                            [n for n, _ in model.named_parameters()])
    for name, p in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        mod._parameters[leaf] = torch.nn.Parameter(
            distribute(p.detach(), mesh, specs[name]),
            requires_grad=p.requires_grad)
    model.mesh = mesh
    return model


def distribute_batch(batch: Mapping[str, torch.Tensor], specs: Mapping,
                     mesh) -> Dict[str, torch.Tensor]:
    """A batch (the same on every rank) as DTensors of ``specs``; a key
    without a spec (``pos``) is kept as it is."""
    return {k: distribute(v, mesh, specs[k])
            if isinstance(v, torch.Tensor) and k in specs else v
            for k, v in batch.items()}


def _as_param(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """A gradient in its parameter's placements (a replicated parameter's
    gradient from local shards arrives partial: this is the data-parallel
    all-reduce)."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(model: Transformer, opt_cfg: Optional[AdamWConfig] = None,
                    *, microbatches: int = 1, grad_compression: bool = False):
    """Returns (train_step, opt_init) for a ``trainable`` model.
    ``train_step(opt_state, batch) -> (opt_state, metrics)`` updates the
    model's parameters in place (the reference donates its buffers instead
    and returns new ones); ``opt_init()`` builds the optimizer state,
    ``{"adam": ..., "ef": ...}`` (``ef`` with ``grad_compression``).

    As the reference's: the loss and grads of ``loss_fn``; with
    ``microbatches`` > 1 the batch's leading dim is cut into that many
    slices, their losses and grads summed in ``cfg.grad_accum_dtype`` and
    scaled by 1 / microbatches; then the optional error-feedback int8
    compression, then AdamW (weight decay by the reference's stacked-leaf
    rule, ``convert.decayed``).  With one microbatch the grads are left in
    each parameter's ``.grad`` after the step (cleared at the next one).
    Metrics: ``loss``, ``grad_norm`` (0-d tensors: reading them syncs the
    host) and ``lr``."""
    cfg = model.cfg
    opt_cfg = opt_cfg or AdamWConfig(moment_dtype=cfg.moment_dtype)
    params = dict(model.named_parameters())
    if not all(p.requires_grad for p in params.values()):
        raise ValueError("make_train_step: the model is frozen; build it "
                         "with Transformer(..., trainable=True)")
    decay = decayed(params)

    def grads_of(batch) -> tuple:
        for p in params.values():
            p.grad = None
        if microbatches <= 1:
            loss = loss_fn(model, batch)[0]
            loss.backward()
            return loss.detach(), {
                n: _as_param(p, p.grad) if p.grad is not None
                else torch.zeros_like(p) for n, p in params.items()}
        n_rows = batch["tokens"].shape[0]
        if n_rows % microbatches:
            raise ValueError(f"batch of {n_rows} rows does not split into "
                             f"{microbatches} microbatches")
        per = n_rows // microbatches
        acc_dt = dtype_of(cfg.grad_accum_dtype)
        lsum = torch.zeros((), device=model.device)
        gsum = {n: torch.zeros_like(p, dtype=acc_dt) if isinstance(
                    p, DTensor) else torch.zeros(p.shape, dtype=acc_dt,
                                                 device=p.device)
                for n, p in params.items()}
        for i in range(microbatches):
            one = {k: _rows(v, i * per, (i + 1) * per, microbatches)
                   for k, v in batch.items()}
            loss = loss_fn(model, one)[0]
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
            lsum = lsum + full_value(loss.detach())
            for (n, acc), g in zip(gsum.items(), grads):
                if g is not None:
                    acc += _as_param(params[n], g).to(acc_dt)
        scale = 1.0 / microbatches
        return lsum * scale, {n: g * scale for n, g in gsum.items()}

    def train_step(opt_state: Dict, batch: Dict) -> tuple:
        with _mesh_of(model):
            return _train_step(opt_state, batch)

    def _train_step(opt_state: Dict, batch: Dict) -> tuple:
        loss, grads = grads_of(batch)
        out_state = {}
        if grad_compression:
            grads, out_state["ef"] = compress_decompress_ef(grads,
                                                            opt_state["ef"])
        _, out_state["adam"], metrics = adamw_update(
            params, grads, opt_state["adam"], opt_cfg, decay=decay)
        return out_state, dict(metrics, loss=full_value(loss))

    def opt_init() -> Dict:
        st = {"adam": adamw_init(params, opt_cfg)}
        if grad_compression:
            st["ef"] = ef_state_init(params)
        return st

    return train_step, opt_init


def _mesh_of(model: Transformer):
    """``use_mesh`` of the model's mesh (``distribute_model``), or a
    context that does nothing."""
    mesh = getattr(model, "mesh", None)
    return use_mesh(mesh) if mesh is not None else contextlib.nullcontext()


def _rows(v: torch.Tensor, a: int, b: int, parts: int) -> torch.Tensor:
    """Microbatch rows a:b of a batch tensor; on a mesh the same part of
    each rank's local rows (the microbatches' union is the batch)."""
    if not isinstance(v, DTensor):
        return v[a:b]
    local = v.to_local()
    n = local.shape[0] // parts
    i = a // (b - a)
    return DTensor.from_local(local[i * n:(i + 1) * n], v.device_mesh,
                              v.placements, run_check=False)


def make_prefill_step(model: Transformer, max_len: int):
    """``prefill_step(batch) -> (last logits (B, 1, V), cache)``; batch keys:
    ``tokens`` (B, S), and ``img_embeds`` (B, N, d) for an ``img_tokens``
    config (``max_len`` counts its N positions) or ``frames`` (B, T, d) for
    an ``is_encdec`` one."""
    def prefill_step(batch):
        with _mesh_of(model):
            return model.prefill(batch["tokens"], max_len=max_len,
                                 img_embeds=batch.get("img_embeds"),
                                 frames=batch.get("frames"))
    return prefill_step


def make_decode_step(model: Transformer):
    """``decode_step(batch) -> (logits (B, 1, V), cache)``; batch keys:
    ``token`` (B, 1), ``pos`` (int), ``caches`` (the prefill's cache; an
    ``is_encdec`` model's holds the cross K/V, so no ``enc_out``)."""
    def decode_step(batch):
        with _mesh_of(model):
            return model.decode_step(batch["token"], batch["pos"],
                                     batch["caches"])
    return decode_step
