"""Train, prefill and decode step builders (counterpart:
``repro/launch/steps.py`` ``make_train_step`` / ``make_prefill_step`` /
``make_decode_step``).

Steps take the reference's batch dicts.  There is no ``jit``: PyTorch runs
eagerly, and the kernels launch on the current CUDA stream.  The sharding
specs of the reference (``fit_spec``, ``*_pspecs``) are not ported: one
card.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.convert import decayed
from repro_torch.models.common import dtype_of
from repro_torch.models.transformer import Transformer, loss_fn
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               compress_decompress_ef, ef_state_init)


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
                n: p.grad if p.grad is not None else torch.zeros_like(p)
                for n, p in params.items()}
        n_rows = batch["tokens"].shape[0]
        if n_rows % microbatches:
            raise ValueError(f"batch of {n_rows} rows does not split into "
                             f"{microbatches} microbatches")
        per = n_rows // microbatches
        acc_dt = dtype_of(cfg.grad_accum_dtype)
        lsum = torch.zeros((), device=model.device)
        gsum = {n: torch.zeros(p.shape, dtype=acc_dt, device=p.device)
                for n, p in params.items()}
        for i in range(microbatches):
            one = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            loss = loss_fn(model, one)[0]
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
            lsum = lsum + loss.detach()
            for acc, g in zip(gsum.values(), grads):
                if g is not None:
                    acc += g.to(acc_dt)
        scale = 1.0 / microbatches
        return lsum * scale, {n: g * scale for n, g in gsum.items()}

    def train_step(opt_state: Dict, batch: Dict) -> tuple:
        loss, grads = grads_of(batch)
        out_state = {}
        if grad_compression:
            grads, out_state["ef"] = compress_decompress_ef(grads,
                                                            opt_state["ef"])
        _, out_state["adam"], metrics = adamw_update(
            params, grads, opt_state["adam"], opt_cfg, decay=decay)
        return out_state, dict(metrics, loss=loss)

    def opt_init() -> Dict:
        st = {"adam": adamw_init(params, opt_cfg)}
        if grad_compression:
            st["ef"] = ef_state_init(params)
        return st

    return train_step, opt_init


def make_prefill_step(model: Transformer, max_len: int):
    """``prefill_step(batch) -> (last logits (B, 1, V), cache)``; batch keys:
    ``tokens`` (B, S), and ``img_embeds`` (B, N, d) for an ``img_tokens``
    config (``max_len`` counts its N positions) or ``frames`` (B, T, d) for
    an ``is_encdec`` one."""
    def prefill_step(batch):
        return model.prefill(batch["tokens"], max_len=max_len,
                             img_embeds=batch.get("img_embeds"),
                             frames=batch.get("frames"))
    return prefill_step


def make_decode_step(model: Transformer):
    """``decode_step(batch) -> (logits (B, 1, V), cache)``; batch keys:
    ``token`` (B, 1), ``pos`` (int), ``caches`` (the prefill's cache; an
    ``is_encdec`` model's holds the cross K/V, so no ``enc_out``)."""
    def decode_step(batch):
        return model.decode_step(batch["token"], batch["pos"], batch["caches"])
    return decode_step
