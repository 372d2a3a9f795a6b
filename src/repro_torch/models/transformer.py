"""Decoder LM: forward, decode caches, prefill and greedy-decode steps.

Counterpart: ``repro/models/transformer.py`` (``_attn_apply``,
``_mlp_apply``, ``_layer_apply``, ``encode``, ``_unembed``, ``forward``,
``init_cache``, ``prefill``, ``decode_step``).  The reference stacks the
layers of each segment on a leading axis and scans them; here every layer
is its own module and a Python loop runs them (``repro_torch.convert``
unstacks reference params).  Layer kinds: full causal attention
(``attn``, and llama4's ``attn_global``), sliding-window attention with a
rolling cache (``attn_local``), chunked attention with a rolling chunk
buffer (``attn_chunk``: a query sees the earlier keys of its own chunk of
``attn_chunk`` positions), the RG-LRU block (``rglru``) and the Mamba-1
block (``mamba``); an ``ssm``-family layer has no MLP.  An ``n_experts``
config puts the MoE FFN (``models/moe.py``) in place of the MLP on every
``moe_every``-th layer.  A ``vlm`` config (``img_tokens``) takes precomputed image-patch
embeddings (B, N, d), projected by ``img_proj`` and put before the token
embeddings: positions and the causal mask run over the N image tokens, then
the text, and decoding goes on at position N + S (the vision frontend is a
stub, as in the reference).  An ``is_encdec`` config (whisper) takes
precomputed frame embeddings (B, T, d) instead (the conv frontend is a stub
too): an encoder of ``n_enc_layers`` bidirectional layers over them with
learned positions, then decoder layers with causal self-attention and cross
attention to the encoder's output, learned positions ``dec_pos_embed`` on
the tokens and no RoPE anywhere.  The cross K/V are projected once, in the
prefill, and kept in the cache (the reference re-projects them from the
encoder output in every decode step: the same products).

Numerics follow the reference: the residual stream, projections and MLP run
in the param dtype; RMSNorm is fp32 inside and rounds to the dtype (through
the fused kernel, plain form: ``x + mix`` is rounded before it is
normalised, as the reference does); LayerNorm is fp32 inside, eps 1e-5;
RoPE angles are fp32; recurrent states are fp32; the logits are ``x @ unembed`` (or ``x @ embed.T`` when tied) in
the dtype, then cast to fp32.  Attention keeps its probabilities in fp32
(the flash kernel's numerics), where the reference's dense path rounds them
to the dtype before P.V; the two agree tightly in fp32 only.

Training: ``Transformer(..., trainable=True)`` unfreezes every parameter,
``forward(..., return_aux=True)`` also returns the MoE load-balance loss
summed over the layers (the reference's ``_run_segments`` sum), and
``loss_fn`` is the reference's next-token cross entropy plus
``aux_weight`` times that sum.  On the card, autograd runs through the
kernels' own backward kernels: RMSNorm, flash attention (windows and head
dim 256 included), the gated RG-LRU and the Mamba scan; on the CPU through
the plain versions.  All ten configs train.  ``cfg.remat`` (``"full"``,
``"selective"``) recomputes activations in the backward as the reference's
``_remat_wrap`` does (``models/remat.py``): one checkpoint around each
repeat of a segment's layer pattern (``layer_groups``: a layer of qwen2-7b
or dbrx-132b, a 3-layer pattern of recurrentgemma-2b and its remainder,
``global_every`` layers of llama4) and around each encoder layer.  Other
model features raise ``NotImplementedError`` naming their slice.

On a mesh (``launch.steps.distribute_model``: every parameter a DTensor of
its reference leaf's spec, ``param_pspecs`` without the layer axis) the
same modules run on DTensors.  ``shard`` pins the activations where the
reference constrains them (the embeddings, q/k/v, the MLP's hidden, each
layer's output, the logits; and the sums of the learned positions, which
DTensor's propagation would otherwise split along the sequence), DTensor
carries the products and elementwise ops, and each kernel runs on local
shards through ``local_map``: the norms by rows, attention by batch and
heads (``models/attention.py``), the recurrent blocks' convolutions and
scans by batch and channels, the MoE as the reference's grouped slot
buffers (``models/moe.py:moe_on_mesh``).  ``init_cache`` then makes
DTensor caches of ``cache_specs`` (``cache_pspecs`` without the layer
axis), which ``write_cache_shards`` fills rank by rank.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.attention import attention
from repro_torch.models.common import (
    BATCH, HEADS, SEQ, PSpec, _axis_size, _mesh_sizes, act_fn, apply_rope,
    dense_init, dtype_of, embed_init, fit_entries, gathered, layernorm,
    local_call,
    local_slice, lookup, merge_heads, param, placements, pspec, replicated,
    rmsnorm, rows_placements, shard, shard_index, sharding_mode, split_heads,
    use_mesh)
from repro_torch.models.mamba import Mamba, mamba_param_specs
from repro_torch.models.moe import MoE, moe_param_specs
from repro_torch.models.remat import remat_wrap
from repro_torch.models.rglru import RGLRU, rglru_param_specs

_LATER = "a later slice of the port (ROADMAP.md, queue A)"
PORTED_KINDS = ("attn", "attn_local", "attn_chunk", "attn_global",
                "rglru", "mamba")
PORTED_MLPS = ("swiglu", "geglu", "gelu")
#: rows of the decoder's learned positions (the reference's table)
DEC_POSITIONS = 32_768


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for anything the port does not run."""
    for kind in sorted(set(cfg.layer_kinds()) - set(PORTED_KINDS)):
        raise NotImplementedError(
            f"{cfg.name}: layer kind {kind!r} is not ported yet; it comes "
            f"with {_LATER}")
    unported = (
        (f"mlp={cfg.mlp!r}", cfg.mlp not in PORTED_MLPS, _LATER),
        ("attn_logit_softcap", cfg.attn_logit_softcap, _LATER),
    )
    for what, present, where in unported:
        if present:
            raise NotImplementedError(
                f"{cfg.name}: {what} is not ported yet; it comes with {where}")


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


def layer_groups(cfg: ModelConfig) -> List[range]:
    """The layers of each repeat of each segment's pattern, in layer order:
    the units that ``remat`` wraps, as the reference's scan bodies."""
    out, i = [], 0
    for pattern, reps in segments(cfg):
        for _ in range(reps):
            out.append(range(i, i + len(pattern)))
            i += len(pattern)
    return out


# ---- sharding specs (the reference's, in its stacked tree) ----

FSDP = BATCH   # parameter sharding axes (ZeRO-3 over the data axes)


def _norm_specs(cfg: ModelConfig) -> Dict:
    return {k: pspec(None) for k in
            (("scale", "bias") if cfg.norm == "layernorm" else ("scale",))}


def _attn_specs(cfg: ModelConfig) -> Dict:
    p = {"wq": pspec(FSDP, "model"), "wk": pspec(FSDP, "model"),
         "wv": pspec(FSDP, "model"), "wo": pspec("model", FSDP)}
    if cfg.qkv_bias:
        p.update(bq=pspec("model"), bk=pspec("model"), bv=pspec("model"))
    return p


def _mlp_specs(cfg: ModelConfig) -> Dict:
    p = {"w_up": pspec(FSDP, "model"), "w_down": pspec("model", FSDP)}
    if cfg.mlp in ("swiglu", "geglu"):
        p["w_gate"] = pspec(FSDP, "model")
    return p


def _layer_specs(kind: str, cfg: ModelConfig, with_cross=False,
                 pattern_pos: int = 0) -> Dict:
    p: Dict = {"norm1": _norm_specs(cfg)}
    if kind.startswith("attn"):
        p["attn"] = _attn_specs(cfg)
    elif kind == "mamba":
        p["mamba"] = mamba_param_specs(cfg)
    elif kind == "rglru":
        p["rglru"] = rglru_param_specs(cfg)
    if with_cross:
        p["norm_cross"] = _norm_specs(cfg)
        p["cross"] = _attn_specs(cfg)
    if cfg.family != "ssm":
        p["norm2"] = _norm_specs(cfg)
        if uses_moe(cfg, pattern_pos):
            p["moe"] = moe_param_specs(cfg)
        else:
            p["mlp"] = _mlp_specs(cfg)
    return p


def _map_specs(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return fn(tree)


def param_pspecs(cfg: ModelConfig) -> Dict:
    """The reference's ``param_pspecs``: a spec for every leaf of its
    params tree, the stacked leaves with an unsharded leading layer axis;
    in ``fsdp`` mode every parameter of two or more dims sharded on dim 0
    over all the mesh's axes and the vectors replicated.  The port's
    parameters take these without the layer axis
    (``launch.steps.param_specs``)."""
    specs: Dict = {"embed": pspec("model", FSDP),
                   "final_norm": _norm_specs(cfg)}
    if not cfg.tie_embeddings:
        specs["unembed"] = pspec(FSDP, "model")

    def seg_specs(pattern, with_cross=False):
        return {f"pos{pi}": _layer_specs(kind, cfg, with_cross,
                                         pattern_pos=pi)
                for pi, kind in enumerate(pattern)}

    specs["segments"] = {f"seg{si}": seg_specs(pat, cfg.is_encdec)
                         for si, (pat, _) in enumerate(segments(cfg))}
    if cfg.is_encdec:
        specs["enc"] = {"pos_embed": pspec(None, FSDP),
                        "segments": {"seg0": seg_specs(("attn_bidir",))},
                        "final_norm": _norm_specs(cfg)}
        specs["dec_pos_embed"] = pspec(None, FSDP)
    if cfg.img_tokens:
        specs["img_proj"] = pspec(FSDP, "model")
    if sharding_mode() == "fsdp":
        all_ax = ("pod", "data", "model")

        def to_fsdp(s: PSpec) -> PSpec:
            if len(s) < 2:
                return pspec(None) if len(s) else s
            return pspec(all_ax, *([None] * (len(s) - 1)))
        specs = _map_specs(to_fsdp, specs)

    def add_layer_axis(tree):
        return _map_specs(lambda s: PSpec(None, *s), tree)
    specs["segments"] = add_layer_axis(specs["segments"])
    if cfg.is_encdec:
        specs["enc"]["segments"] = add_layer_axis(specs["enc"]["segments"])
    return specs


def cache_pspecs(cfg: ModelConfig, *, shard_seq: bool = False) -> Dict:
    """The reference's ``cache_pspecs``, in its stacked cache tree: batch
    over (pod, data); the KV heads over ``model`` where they divide it,
    else the sequence takes ``model``; ``shard_seq`` (a batch of one) puts
    the batch axes on the sequence too."""
    msz = _axis_size("model")
    heads_shardable = msz > 1 and cfg.n_kv_heads % msz == 0
    batch_ax = None if shard_seq else BATCH
    seq_axes: list = ["pod", "data"] if shard_seq else []
    if not heads_shardable and msz > 1:
        seq_axes.append("model")
    seq_ax = tuple(seq_axes) if seq_axes else None
    head_ax = "model" if heads_shardable else None
    state_ax = tuple(seq_axes + (["model"] if heads_shardable else [])) \
        if shard_seq else "model"
    spec_for = {
        "k": pspec(None, batch_ax, seq_ax, head_ax, None),
        "kpos": pspec(None, None),
        "ssm": pspec(None, batch_ax, state_ax, None),
        "h": pspec(None, batch_ax, state_ax),
        "conv": pspec(None, batch_ax, None, state_ax)}
    spec_for["v"] = spec_for["k"]
    tree: Dict = {}
    for si, (pattern, _) in enumerate(segments(cfg)):
        seg = {}
        for pi, kind in enumerate(pattern):
            if kind.startswith("attn"):
                names = {"attn": ("k", "v", "kpos")}
            elif kind == "mamba":
                names = {None: ("ssm", "conv")}
            else:
                names = {None: ("h", "conv")}
            pos = {}
            for group, leaves in names.items():
                d = {n: spec_for[n] for n in leaves}
                pos.update({group: d} if group else d)
            seg[f"pos{pi}"] = pos
        tree[f"seg{si}"] = seg
    return tree


def cache_specs(cfg: ModelConfig, *, shard_seq: bool = False
                ) -> List[Dict[str, PSpec]]:
    """The spec of each entry of each layer's cache (``Cache.layers``):
    the reference's cache leaf's without the stacked layer axis; an
    encoder-decoder's cross K/V (which the reference recomputes from
    ``enc_out``) as the self K/V with the sequence unsharded."""
    from repro_torch.convert import leaf_at, reference_leaf
    tree = cache_pspecs(cfg, shard_seq=shard_seq)
    out = []
    for i, kind in enumerate(cfg.layer_kinds()):
        keys, r = reference_leaf(f"layers.{i}.x", cfg)
        pos = leaf_at({"segments": tree}, keys[:-1])
        leaves = dict(pos.get("attn", pos))
        specs = {n: PSpec(*s[1:]) for n, s in leaves.items()}
        if cfg.is_encdec:
            k = specs["k"]
            specs["cross_k"] = specs["cross_v"] = PSpec(k[0], None, *k[2:])
        out.append(specs)
    return out


def distribute(t: torch.Tensor, mesh, spec) -> DTensor:
    """``t`` (the same on every rank) as a DTensor of ``spec`` fitted to
    its shape: each rank keeps a copy of its own slice, split in mesh-dim
    order as DTensor splits, with no communication."""
    pl = placements(fit_entries(spec, t.shape, _mesh_sizes(mesh)), mesh)
    return DTensor.from_local(local_slice(t, mesh, pl), mesh, pl,
                              run_check=False)


LayerCache = Dict[str, torch.Tensor]


@dataclass
class Cache:
    """Decode caches, one dict per layer (the reference's ``init_cache``,
    unstacked), updated in place; ``length`` positions are written.

    - attention: ``k``, ``v`` (B, L, Hkv, D) in the model's dtype.  A full
      causal layer has L = max_len and slot i holds position i.  A
      sliding-window layer has a rolling buffer of L = min(2 * window,
      max_len) slots, a chunked layer one of L = min(attn_chunk, max_len),
      position p in slot p % L, and ``kpos`` (L,) int32, the position in
      each slot (-1: unwritten).
    - RG-LRU: ``h`` (B, W) fp32 and ``conv`` (B, K-1, W).
    - Mamba: ``ssm`` (B, Di, N) fp32 and ``conv`` (B, K-1, Di).
    - an ``is_encdec`` decoder layer also holds ``cross_k``, ``cross_v``
      (B, T, Hkv, D) in the dtype: its cross-attention K/V, projected from
      the T encoder states by the prefill.
    """
    layers: List[LayerCache]
    length: int = 0


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype, device):
        super().__init__()
        self.scale = param(torch.ones(d, dtype=dtype, device=device))

    def forward(self, x):
        return rmsnorm(self.scale, x)


class LayerNorm(nn.Module):
    def __init__(self, d: int, dtype, device):
        super().__init__()
        self.scale = param(torch.ones(d, dtype=dtype, device=device))
        self.bias = param(torch.zeros(d, dtype=dtype, device=device))

    def forward(self, x):
        return layernorm(self.scale, self.bias, x)


def make_norm(cfg: ModelConfig, dtype, device) -> nn.Module:
    return (RMSNorm if cfg.norm == "rmsnorm" else LayerNorm)(
        cfg.d_model, dtype, device)


def uses_moe(cfg: ModelConfig, i: int) -> bool:
    """Layer i has the MoE FFN: the reference's ``_use_moe`` by pattern
    position, which equals the layer index here because the pattern length
    is a multiple of ``moe_every``."""
    return bool(cfg.n_experts) and (i + 1) % cfg.moe_every == 0


@torch.no_grad()
def write_cache_shards(cache: LayerCache, k: DTensor, v: DTensor,
                       positions: torch.Tensor, pos: int) -> None:
    """Write the K/V of positions ``pos ..`` into a cache of DTensors, each
    rank its own slots: the new K/V are brought to the cache's placements
    (the sequence whole), and a rank whose slots are split along the
    sequence writes those of its range.  Slots follow the plain path's
    rule: position p in slot p, or p % L in a rolling buffer, a prompt
    longer than the buffer leaving its last L positions."""
    ck, cv, kpos = cache["k"], cache["v"], cache.get("kpos")
    mesh, L, S = ck.device_mesh, ck.shape[1], k.shape[1]
    if kpos is None and pos + S > L:
        raise ValueError(f"cache of {L} slots is full at position "
                         f"{pos + S - 1}")
    want = tuple(p if not p.is_shard(1) else Replicate()
                 for p in ck.placements)
    kl = k.redistribute(mesh, want).to_local()
    vl = v.redistribute(mesh, want).to_local()
    ckl, cvl = ck.to_local(), cv.to_local()
    n = ckl.shape[1]
    lo = shard_index(mesh, ck.placements, 1)[0] * n
    if S <= L:
        slot = pos % L
        a, b = max(slot, lo), min(slot + S, lo + n)
        if a < b:
            ckl[:, a - lo:b - lo] = kl[:, a - slot:b - slot]
            cvl[:, a - lo:b - lo] = vl[:, a - slot:b - slot]
        if kpos is not None:
            kpos.to_local()[slot:slot + S] = positions.to(kpos.dtype)
    else:
        # slot s holds the last-L position p with p % L == s
        rows = (torch.arange(lo, lo + n, device=kl.device)
                - (pos + S - L)) % L + (S - L)
        ckl.copy_(kl[:, rows])
        cvl.copy_(vl[:, rows])
        kpos.to_local()[positions[-L:] % L] = positions[-L:].to(kpos.dtype)


class Attention(nn.Module):
    """Self-attention of a layer kind: ``attn`` and ``attn_global``
    (causal), ``attn_local`` (causal, sliding window), ``attn_chunk``
    (causal within chunks of ``attn_chunk`` positions) or ``attn_bidir``
    (the encoder's, no mask); or an ``attn_cross`` layer's cross attention
    (``kv_from``, ``attend``).  RoPE rotates Q and K of causal
    self-attention outside an ``is_encdec`` model only (every layer of
    llama4, its global ones too, as the reference)."""

    def __init__(self, cfg: ModelConfig, kind: str, dtype, device,
                 generator):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        self.cfg = cfg
        self.window = cfg.attn_window if kind == "attn_local" else 0
        self.chunk = cfg.attn_chunk if kind == "attn_chunk" else 0
        self.causal = kind not in ("attn_bidir", "attn_cross")
        self.rope = self.causal and not cfg.is_encdec
        self.wq = param(dense_init(d, cfg.n_heads * hd, dtype, device, generator))
        self.wk = param(dense_init(d, cfg.n_kv_heads * hd, dtype, device, generator))
        self.wv = param(dense_init(d, cfg.n_kv_heads * hd, dtype, device, generator))
        self.wo = param(dense_init(cfg.n_heads * hd, d, dtype, device, generator))
        if cfg.qkv_bias:
            for name, width in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                                ("bv", cfg.n_kv_heads)):
                setattr(self, name, param(torch.zeros(
                    width * hd, dtype=dtype, device=device)))

    def _proj(self, x, w, bias_name):
        y = x @ gathered(w)
        return y + getattr(self, bias_name) if self.cfg.qkv_bias else y

    def forward(self, x, pos: int = 0, cache: Optional[LayerCache] = None):
        """x: (B, S, d), the tokens at positions ``pos .. pos+S-1``.  A
        prompt (S > 1, from position 0) attends over its own K/V; a decode
        step (S == 1) over the cache.  With ``cache`` (this layer's) the new
        K/V are written into it, a prompt longer than a rolling buffer
        leaving its last L tokens."""
        cfg = self.cfg
        B, S, _ = x.shape
        hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        q = shard(split_heads(self._proj(x, self.wq, "bq"), hq, hd),
                  BATCH, SEQ, HEADS, None)
        k = shard(split_heads(self._proj(x, self.wk, "bk"), hkv, hd),
                  BATCH, SEQ, HEADS, None)
        v = shard(split_heads(self._proj(x, self.wv, "bv"), hkv, hd),
                  BATCH, SEQ, HEADS, None)
        positions = torch.arange(pos, pos + S, device=x.device)
        if self.rope:
            q = apply_rope(q, positions, fraction=cfg.rope_fraction,
                           theta=cfg.rope_theta)
            k = apply_rope(k, positions, fraction=cfg.rope_fraction,
                           theta=cfg.rope_theta)
        if cache is None or S > 1:
            if pos:
                raise ValueError("a multi-token call starts at position 0")
            out = attention(q, k, v, causal=self.causal, window=self.window,
                            chunk=self.chunk)
        if cache is not None and isinstance(cache["k"], DTensor):
            write_cache_shards(cache, k, v, positions, pos)
            if S == 1:
                out = attention(q, cache["k"], cache["v"], q_offset=pos,
                                kv_len=min(pos + 1, cache["k"].shape[1]),
                                k_pos=cache.get("kpos"), window=self.window,
                                chunk=self.chunk)
        elif cache is not None:
            ck, cv, kpos = cache["k"], cache["v"], cache.get("kpos")
            L = ck.shape[1]
            if kpos is None and pos + S > L:
                raise ValueError(f"cache of {L} slots is full at position "
                                 f"{pos + S - 1}")
            if S <= L:            # no wrap within the call
                slot = pos % L
                ck[:, slot:slot + S] = k
                cv[:, slot:slot + S] = v
                if kpos is not None:
                    kpos[slot:slot + S] = positions
            else:                 # a prompt longer than the rolling buffer
                slots = positions[-L:] % L
                ck[:, slots] = k[:, -L:]
                cv[:, slots] = v[:, -L:]
                kpos[slots] = positions[-L:].to(kpos.dtype)
            if S == 1:
                out = attention(q, ck, cv, q_offset=pos,
                                kv_len=min(pos + 1, L), k_pos=kpos,
                                window=self.window, chunk=self.chunk)
        return merge_heads(out) @ gathered(self.wo)

    def kv_from(self, src: torch.Tensor):
        """Cross attention's K and V (B, T, Hkv, D) from the encoder states
        src (B, T, d), without ``bk``/``bv`` (the reference's ``kv_src``)."""
        hkv, hd = self.cfg.n_kv_heads, self.cfg.resolved_head_dim
        return (split_heads(src @ gathered(self.wk), hkv, hd),
                split_heads(src @ gathered(self.wv), hkv, hd))

    def attend(self, x, k, v):
        """Cross attention of x (B, S, d) over every key of ``kv_from``."""
        cfg = self.cfg
        B, S, _ = x.shape
        q = split_heads(self._proj(x, self.wq, "bq"), cfg.n_heads,
                        cfg.resolved_head_dim)
        out = attention(q, k, v, causal=False)
        return merge_heads(out) @ gathered(self.wo)


class MLP(nn.Module):
    """SwiGLU, GeGLU, or the non-gated ``gelu`` MLP (``w_up``, ``w_down``
    only); the GELU is the tanh form (``jax.nn.gelu``)."""

    def __init__(self, cfg: ModelConfig, dtype, device, generator):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.act = act_fn("silu" if cfg.mlp == "swiglu" else "gelu")
        if cfg.mlp != "gelu":
            self.w_gate = param(dense_init(d, f, dtype, device, generator))
        self.w_up = param(dense_init(d, f, dtype, device, generator))
        self.w_down = param(dense_init(f, d, dtype, device, generator))

    def forward(self, x):
        if not hasattr(self, "w_gate"):
            h = self.act(x @ gathered(self.w_up))
        else:
            h = self.act(x @ gathered(self.w_gate)) * (
                x @ gathered(self.w_up))
        return shard(h, BATCH, SEQ, HEADS) @ gathered(self.w_down)


class Layer(nn.Module):
    """Pre-norm residual layer: a token mixer of its kind, then in a decoder
    layer of an ``is_encdec`` model cross attention to the encoder, then
    (outside the ``ssm`` family) an MLP, or with ``moe`` the MoE FFN, whose
    load-balance loss serving drops.  Norms by ``cfg.norm``."""

    def __init__(self, cfg: ModelConfig, kind: str, dtype, device,
                 generator, with_cross: bool = False, moe: bool = False):
        super().__init__()
        self.norm1 = make_norm(cfg, dtype, device)
        # the mixer under the reference's name of its params
        self.mixer = "attn" if kind.startswith("attn") else kind
        if self.mixer == "attn":
            self.attn = Attention(cfg, kind, dtype, device, generator)
        elif kind == "rglru":
            self.rglru = RGLRU(cfg, dtype, device, generator)
        else:
            self.mamba = Mamba(cfg, dtype, device, generator)
        if with_cross:
            self.norm_cross = make_norm(cfg, dtype, device)
            self.cross = Attention(cfg, "attn_cross", dtype, device,
                                   generator)
        if cfg.family != "ssm":
            self.norm2 = make_norm(cfg, dtype, device)
            if moe:
                self.moe = MoE(cfg, dtype, device, generator)
            else:
                self.mlp = MLP(cfg, dtype, device, generator)

    def forward(self, x, pos: int = 0, cache: Optional[LayerCache] = None,
                enc: Optional[torch.Tensor] = None):
        """``enc``: the encoder's output (B, T, d), which a cross-attention
        layer projects to K/V (and keeps in ``cache``); without it such a
        layer reads them from ``cache`` (a decode step)."""
        return self.run(x, pos, cache, enc)[0]

    def run(self, x, pos: int = 0, cache: Optional[LayerCache] = None,
            enc: Optional[torch.Tensor] = None):
        """``forward``, returning (x, the MoE FFN's aux loss: an fp32 0-d
        tensor, or None without one)."""
        aux = None
        x = x + getattr(self, self.mixer)(self.norm1(x), pos, cache)
        if hasattr(self, "cross"):
            if enc is None:
                kv = cache["cross_k"], cache["cross_v"]
            else:
                kv = self.cross.kv_from(enc)
                if cache is not None:
                    cache["cross_k"], cache["cross_v"] = kv
            x = x + self.cross.attend(self.norm_cross(x), *kv)
        if hasattr(self, "mlp"):
            x = x + self.mlp(self.norm2(x))
        elif hasattr(self, "moe"):
            y, aux = self.moe(self.norm2(x))
            x = x + y
        return shard(x, BATCH, SEQ, None), aux


def run_layers(layers: Sequence[Layer], x: torch.Tensor,
               aux: Optional[torch.Tensor], enc: Optional[torch.Tensor]):
    """(x after ``layers`` in order, ``aux`` plus their MoE aux losses, or
    None when ``aux`` is None): the reference's scan body, with its
    carry."""
    for layer in layers:
        x, a = layer.run(x, enc=enc)
        if aux is not None and a is not None:
            aux = aux + a
    return x, aux


class Encoder(nn.Module):
    """whisper's encoder (the reference's ``encode``): learned positions
    ``pos_embed`` (enc_seq, d) added to the frames, ``n_enc_layers``
    bidirectional layers without cross attention, then ``final_norm``.  Its
    layers see the config as the reference runs them, with ``is_encdec``
    off (and no MoE)."""

    def __init__(self, cfg: ModelConfig, dtype, device, generator):
        super().__init__()
        enc_cfg = replace(cfg, is_encdec=False, n_experts=0)
        self.pos_embed = param(embed_init(cfg.enc_seq, cfg.d_model, dtype,
                                          device, generator))
        self.layers = nn.ModuleList(
            Layer(enc_cfg, "attn_bidir", dtype, device, generator)
            for _ in range(cfg.n_enc_layers))
        self.final_norm = make_norm(cfg, dtype, device)
        self.remat = cfg.remat

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, T, d) in the model's dtype, T <= enc_seq."""
        # pinned as the layers' outputs are: DTensor's propagation may split
        # T over ``model`` here, where XLA's keeps the reference's layout
        x = shard(frames + self.pos_embed[:frames.shape[1]], BATCH, SEQ,
                  None)
        run = remat_wrap(run_layers, self.remat)
        for layer in self.layers:     # one segment of 1-layer repeats
            x = run((layer,), x, None, None)[0]
        return self.final_norm(x)


class Transformer(nn.Module):
    """Decoder LM with random weights drawn in the reference's scheme
    (normal/sqrt(d_in) projections, 0.02 embeddings, zero biases, unit norm
    scales, the recurrent blocks' own) from ``generator``, or from a
    generator seeded with ``seed``.  Load reference weights with
    ``load_state_dict(params_from_jax(...))``.  An ``is_encdec`` model
    holds an ``Encoder`` (``enc``) and ``dec_pos_embed``, and each of its
    layers cross attention.  The parameters are frozen unless
    ``trainable``."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None, *,
                 seed: int = 0, generator: Optional[torch.Generator] = None,
                 trainable: bool = False):
        super().__init__()
        check_ported(cfg)
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(seed)
        dtype = dtype_of(cfg.param_dtype)
        self.cfg, self.dtype = cfg, dtype
        self.embed = param(embed_init(cfg.vocab, cfg.d_model, dtype, device,
                                      generator))
        self.final_norm = make_norm(cfg, dtype, device)
        if not cfg.tie_embeddings:
            self.unembed = param(dense_init(cfg.d_model, cfg.vocab, dtype,
                                            device, generator))
        self.layers = nn.ModuleList(
            Layer(cfg, kind, dtype, device, generator,
                  with_cross=cfg.is_encdec, moe=uses_moe(cfg, i))
            for i, kind in enumerate(cfg.layer_kinds()))
        self.groups = layer_groups(cfg)
        if cfg.img_tokens:
            self.img_proj = param(dense_init(cfg.d_model, cfg.d_model, dtype,
                                             device, generator))
        if cfg.is_encdec:
            self.enc = Encoder(cfg, dtype, device, generator)
            self.dec_pos_embed = param(embed_init(
                DEC_POSITIONS, cfg.d_model, dtype, device, generator))
        self.requires_grad_(trainable)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _embed(self, tokens: torch.Tensor,
               img_embeds: Optional[torch.Tensor]) -> torch.Tensor:
        """Token embeddings (B, S, d), after the projected image embeddings
        (B, N, d) for an ``img_tokens`` config: (B, N + S, d)."""
        x = shard(lookup(self.embed, tokens), BATCH, SEQ, None)
        if not self.cfg.img_tokens:
            if img_embeds is not None:
                raise ValueError(f"{self.cfg.name} takes no image embeddings")
            return x
        if img_embeds is None:
            raise ValueError(f"{self.cfg.name} needs img_embeds (B, N, "
                             f"{self.cfg.d_model})")
        B = tokens.shape[0]
        if img_embeds.dim() != 3 or img_embeds.shape[0] != B \
                or img_embeds.shape[2] != self.cfg.d_model:
            raise ValueError(f"img_embeds {tuple(img_embeds.shape)}: want "
                             f"({B}, N, {self.cfg.d_model})")
        img = img_embeds.to(x.dtype) @ gathered(self.img_proj)
        return torch.cat([img, x], 1)

    def _inputs(self, tokens: torch.Tensor,
                img_embeds: Optional[torch.Tensor],
                frames: Optional[torch.Tensor]):
        """(the decoder's input (B, positions, d), the encoder's output
        (B, T, d) or None).  An ``is_encdec`` config requires frames
        (B, T, d), T <= enc_seq, cast to the model's dtype and encoded, and
        adds ``dec_pos_embed`` to the tokens; the others refuse frames."""
        cfg = self.cfg
        x = self._embed(tokens, img_embeds)
        if not cfg.is_encdec:
            if frames is not None:
                raise ValueError(f"{cfg.name} takes no frames")
            return x, None
        if frames is None:
            raise ValueError(f"{cfg.name} needs frames (B, T, {cfg.d_model})")
        B = tokens.shape[0]
        if frames.dim() != 3 or frames.shape[0] != B \
                or frames.shape[2] != cfg.d_model \
                or not 0 < frames.shape[1] <= cfg.enc_seq:
            raise ValueError(f"frames {tuple(frames.shape)}: want ({B}, T, "
                             f"{cfg.d_model}), T <= {cfg.enc_seq}")
        x = shard(x + self.dec_pos_embed[:x.shape[1]], BATCH, SEQ, None)
        return x, self.enc(frames.to(self.dtype))

    def _unembed(self, x):
        x = self.final_norm(x)
        w = self.embed.t() if self.cfg.tie_embeddings else self.unembed
        return shard((x @ gathered(w)).float(), BATCH, SEQ, HEADS)

    def forward(self, tokens: torch.Tensor, last: Optional[int] = None,
                img_embeds: Optional[torch.Tensor] = None,
                frames: Optional[torch.Tensor] = None,
                return_aux: bool = False):
        """tokens (B, S) -> logits (B, S, vocab) fp32, no cache; with
        ``last``, the logits of the last ``last`` positions only.  With
        image embeddings (B, N, d) the logits cover all N + S positions, the
        image ones first, as the reference's.  An ``is_encdec`` config
        takes the frames (B, T, d) its decoder attends to.  With
        ``return_aux``: (logits, the MoE aux loss summed over the layers,
        fp32 0-d), as the reference's ``forward``."""
        x, enc = self._inputs(tokens, img_embeds, frames)
        aux = replicated(torch.zeros((), device=x.device), x) \
            if return_aux else None
        run = remat_wrap(run_layers, self.cfg.remat)
        for group in self.groups:
            x, aux = run(tuple(self.layers[i] for i in group), x, aux, enc)
        if last is not None:
            x = x[:, -last:].contiguous()
        logits = self._unembed(x)
        return (logits, aux) if return_aux else logits

    def init_cache(self, batch: int, max_len: int) -> Cache:
        cfg, dt, dev = self.cfg, self.dtype, self.device
        layers: List[LayerCache] = []
        for kind in cfg.layer_kinds():
            if kind.startswith("attn"):
                rolling = {"attn_local": 2 * cfg.attn_window,
                           "attn_chunk": cfg.attn_chunk}.get(kind)
                L = min(rolling, max_len) if rolling else max_len
                shape = (batch, L, cfg.n_kv_heads, cfg.resolved_head_dim)
                c = {"k": torch.zeros(shape, dtype=dt, device=dev),
                     "v": torch.zeros(shape, dtype=dt, device=dev)}
                if rolling:
                    c["kpos"] = torch.full((L,), -1, dtype=torch.int32,
                                           device=dev)
            else:
                width, state = ((cfg.rnn_width, "h") if kind == "rglru"
                                else (cfg.d_inner, "ssm"))
                shape = (batch, width) + ((cfg.ssm_state,) if kind == "mamba"
                                          else ())
                c = {state: torch.zeros(shape, device=dev),
                     "conv": torch.zeros(batch, cfg.ssm_conv - 1, width,
                                         dtype=dt, device=dev)}
            layers.append(c)
        mesh = getattr(self, "mesh", None)
        if mesh is not None:
            with use_mesh(mesh):
                specs = cache_specs(cfg, shard_seq=batch == 1)
            layers = [{n: distribute(t, mesh, specs[i][n])
                       for n, t in c.items()} for i, c in enumerate(layers)]
        return Cache(layers)

    def prefill(self, tokens: torch.Tensor, max_len: int,
                img_embeds: Optional[torch.Tensor] = None,
                frames: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Cache]:
        """Run the prompt (B, S), after the image embeddings (B, N, d) of an
        ``img_tokens`` config, from position 0, filling a fresh cache for
        ``max_len`` positions (image ones included).  An ``is_encdec``
        config encodes its frames (B, T, d) here, and the cache keeps each
        layer's cross K/V.  Returns (last-position logits (B, 1, V), cache
        holding N + S positions)."""
        cache = self.init_cache(tokens.shape[0], max_len)
        x, enc = self._inputs(tokens, img_embeds, frames)
        for layer, c in zip(self.layers, cache.layers):
            x = layer(x, 0, c, enc)
        cache.length = x.shape[1]
        return self._unembed(x[:, -1:].contiguous()), cache

    def decode_step(self, token: torch.Tensor, pos: int,
                    cache: Cache) -> Tuple[torch.Tensor, Cache]:
        """One token (B, 1) at position ``pos`` for the whole batch.  Updates
        ``cache`` in place (the reference returns a new one) and returns
        (logits (B, 1, V), cache)."""
        pos = int(pos)
        if pos != cache.length:
            raise ValueError(f"decode at position {pos} but the cache holds "
                             f"{cache.length} positions")
        x = shard(lookup(self.embed, token), BATCH, SEQ, None)
        if self.cfg.is_encdec:
            x = shard(x + self.dec_pos_embed[pos], BATCH, SEQ, None)
        for layer, c in zip(self.layers, cache.layers):
            x = layer(x, pos, c)
        cache.length = pos + 1
        return self._unembed(x), cache


def _token_logprobs(logits: torch.Tensor, labels: torch.Tensor):
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, labels[..., None])[..., 0]


def token_logprobs(logits: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
    """log_softmax(logits)[..., label] (fp32), each (batch, position) row
    on its own.  On a mesh each rank keeps its rows; where ranks split the
    vocab (the logits' ``HEADS`` split), each takes the log-sum-exp terms
    and the label's logit of its own columns and the ranks sum them
    (``vocab_logprobs``), so no rank holds a row's whole vocab; else the
    rows run whole, locally.  (DTensor's own ``log_softmax`` gathers the
    vocab, and its gradient of ``gather`` makes zeros of the global logits'
    shape on every rank.)"""
    if not isinstance(logits, DTensor):
        return _token_logprobs(logits, labels)
    mesh, last = logits.device_mesh, logits.ndim - 1
    keep = tuple(p if p.is_shard() and (p.dim in (0, 1) or (
        p.dim == last and mesh.size(m) > 1)) else Replicate()
        for m, p in enumerate(logits.placements))
    lab = tuple(p if p.is_shard() and p.dim < last else Replicate()
                for p in keep)
    if keep == lab:                     # the vocab whole on every rank
        return local_call(_token_logprobs, lab, (logits, labels),
                          (keep, lab), (keep, lab))
    return vocab_logprobs(logits, labels, keep, lab)


def vocab_logprobs(logits, labels, keep, lab):
    """``token_logprobs`` over a vocab split by ``keep``'s mesh dims: lse =
    m + log(sum over ranks of sum exp(x - m)), m the row's largest logit
    (a constant to autograd), and the label's logit from the rank whose
    columns hold it."""
    mesh = logits.device_mesh
    first, _ = shard_index(mesh, keep, logits.ndim - 1)
    vmax = tuple(Partial("max") if q != p else p for p, q in zip(keep, lab))
    vsum = tuple(Partial() if q != p else p for p, q in zip(keep, lab))
    m = local_call(lambda x: x.detach().amax(-1), vmax, (logits,), (keep,),
                   (keep,)).redistribute(mesh, lab)

    def parts(x, m, labels):
        n = x.shape[-1]
        ids = labels.long() - first * n
        hit = (ids >= 0) & (ids < n)
        pick = torch.gather(x, -1, ids.clamp(0, n - 1)[..., None])[..., 0]
        return (x - m[..., None]).exp().sum(-1), torch.where(hit, pick, 0.0)
    total, target = local_call(parts, (vsum, vsum), (logits, m, labels),
                               (keep, lab, lab), (keep, lab, lab))
    total = total.redistribute(mesh, lab)
    target = target.redistribute(mesh, lab)
    return target - (m + total.log())


def loss_fn(model: Transformer, batch: Dict[str, torch.Tensor],
            aux_weight: float = 0.01):
    """Next-token cross entropy (+ ``aux_weight`` times the MoE aux loss),
    the reference's ``loss_fn``: fp32 log-softmax of the logits, an
    ``img_tokens`` config's image positions dropped, ``loss_mask`` (B, S)
    honoured.  batch keys: ``tokens``, ``labels`` (B, S_text) aligned with
    the tokens, and ``img_embeds`` / ``frames`` / ``loss_mask`` where the
    config takes them.  Returns (loss, {"ce", "aux"}), 0-d fp32 tensors."""
    logits, aux = model(batch["tokens"], img_embeds=batch.get("img_embeds"),
                        frames=batch.get("frames"), return_aux=True)
    labels = batch["labels"].long()
    if model.cfg.img_tokens:                  # drop image positions
        logits = logits[:, model.cfg.img_tokens:]
    mask = batch.get("loss_mask")
    ll = token_logprobs(logits, labels)
    if mask is not None:
        ll = ll * mask
        denom = torch.clamp(mask.sum(), min=1.0)
    else:
        denom = float(ll.shape[0] * ll.shape[1])
    loss = -(ll.sum() / denom)
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}
