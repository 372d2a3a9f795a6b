"""Shared model building blocks: the sharding vocabulary, dtypes, params,
RMSNorm, LayerNorm, RoPE, init, activations.

Counterpart: ``repro/models/common.py``.  ``rmsnorm`` goes through the fused
kernel's wrapper, so a CUDA tensor runs ``csrc/rmsnorm.cu`` and a CPU tensor
its plain version.  ``layernorm`` is eager PyTorch on both: the reference
computes it outside any Pallas kernel, as it does the projections.

Sharding is the reference's, on PyTorch's own idiom.  A ``PSpec`` is a
tuple of entries, one a tensor dim: ``None``, a mesh axis name, or a tuple
of names.  ``pspec`` resolves the logical entries (``BATCH``, ``SEQ``,
``HEADS``) against the mesh entered with ``use_mesh`` and the sharding mode,
and keeps only the axes the mesh has, as the reference's ``_resolve``.
``placements`` turns a spec into DTensor placements on a
``torch.distributed.device_mesh.DeviceMesh`` with named dims; several mesh
axes on one tensor dim shard it in mesh-dim order, pod-major, as jax does.
``shard(x, ...)``, the reference's ``with_sharding_constraint``, returns x
itself unless x is a DTensor, and otherwise redistributes it, an axis that
does not divide its dim dropping to replication.  Off a mesh every helper
gives the reference's off-mesh answer and no model code path changes.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm


# ---- the sharding vocabulary ----

class PSpec(tuple):
    """A partition spec: one entry a tensor dim, each ``None``, a mesh axis
    name or a tuple of names (the counterpart of jax's ``PartitionSpec``;
    trailing dims left out are unsharded).  A tuple of one name is that
    name, as jax writes it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self):
        return f"PSpec{tuple(self)!r}"


BATCH = ("pod", "data")     # logical batch axes (composed where present)
# logical placeholders resolved per sharding mode:
#   tp   (default): HEADS -> "model" (Megatron TP), SEQ -> unsharded
#   fsdp          : HEADS -> unsharded, SEQ -> "model" (sequence-parallel
#                   activations; params ZeRO-3-sharded over all axes)
SEQ = "__seq__"
HEADS = "__heads__"

_MESH_TLS = threading.local()
_MODE_TLS = threading.local()


@contextlib.contextmanager
def use_mesh(mesh):
    """Enter ``mesh`` (a named ``DeviceMesh``) for the logical-axis
    resolution of ``pspec`` and ``shard``."""
    prev = getattr(_MESH_TLS, "mesh", None)
    _MESH_TLS.mesh = mesh
    try:
        yield mesh
    finally:
        _MESH_TLS.mesh = prev


def current_mesh():
    return getattr(_MESH_TLS, "mesh", None)


def mesh_axis_names() -> Tuple[str, ...]:
    """Axis names of the mesh entered with ``use_mesh`` (none off a mesh)."""
    mesh = current_mesh()
    return tuple(mesh.mesh_dim_names) if mesh is not None else ()


def set_sharding_mode(mode: str):
    assert mode in ("tp", "fsdp")
    _MODE_TLS.mode = mode


def sharding_mode() -> str:
    return getattr(_MODE_TLS, "mode", "tp")


def _resolve(entry, axes):
    if entry is None:
        return None
    if entry == SEQ:
        entry = "model" if sharding_mode() == "fsdp" else None
        return entry if entry in axes else None
    if entry == HEADS:
        entry = "model" if sharding_mode() == "tp" else None
        return entry if entry in axes else None
    if isinstance(entry, str):
        return entry if entry in axes else None
    kept = tuple(a for a in entry if a in axes)   # a tuple: the present ones
    return kept if kept else None


def pspec(*entries) -> PSpec:
    """A spec naming only axes of the active mesh: ``pspec(("pod", "data"),
    None, "model")`` is that on the multi-pod mesh, ``("data", None,
    "model")`` on a single pod and ``(None, None, None)`` off a mesh."""
    axes = mesh_axis_names()
    return PSpec(*[_resolve(e, axes) for e in entries])


def _mesh_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _axis_size(name: str) -> int:
    mesh = current_mesh()
    return 1 if mesh is None else _mesh_sizes(mesh).get(name, 1)


def _names(entry) -> Tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry)


def fit_entries(spec: Sequence, shape: Sequence[int], sizes: dict) -> PSpec:
    """``spec`` over ``shape`` with each entry whose axes' product does not
    divide its dim dropped to ``None`` (trailing dims filled with None)."""
    entries = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    fixed = []
    for dim, entry in zip(shape, entries):
        if entry is None:
            fixed.append(None)
            continue
        total = math.prod(sizes.get(n, 1) for n in _names(entry))
        fixed.append(entry if total and dim % total == 0 else None)
    return PSpec(*fixed)


def placements(spec: Sequence, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dim that an entry of tensor dim d names, ``Replicate()`` on the others.
    A tensor dim over several mesh dims is split in mesh-dim order (pod,
    then data, then model), which is jax's order for the reference's
    tuples; a tuple in another order raises."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        idx = [names.index(n) for n in _names(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def slice_bounds(shape: Sequence[int], mesh, pl) -> list:
    """(start, stop) on each dim of this rank's slice of a tensor of
    ``shape`` under placements ``pl`` (evenly split): a dim over several
    mesh dims is cut by the first, then each part by the next."""
    bounds = [(0, n) for n in shape]
    for m, p in enumerate(pl):
        if p.is_shard():
            start, stop = bounds[p.dim]
            size = (stop - start) // mesh.size(m)
            start += mesh.get_local_rank(m) * size
            bounds[p.dim] = (start, start + size)
    return bounds


def local_slice(t: torch.Tensor, mesh, pl) -> torch.Tensor:
    """This rank's slice of ``t`` under placements ``pl`` (evenly split),
    a tensor of its own unless it is the whole of t."""
    local = t
    for dim, (start, stop) in enumerate(slice_bounds(t.shape, mesh, pl)):
        if stop - start != t.shape[dim]:
            local = local.narrow(dim, start, stop - start)
    if local.numel() != t.numel():
        local = local.clone(memory_format=torch.contiguous_format)
    return local


def shard(x, *entries):
    """The reference's ``with_sharding_constraint`` on a DTensor: x
    redistributed to ``pspec(*entries)``, an axis that does not divide its
    dim dropping to replication.  Anything else is returned as it is."""
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = fit_entries(pspec(*entries), x.shape, _mesh_sizes(mesh))
    want = placements(spec, mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


class _GradAsForward(torch.autograd.Function):
    """Identity whose backward brings the gradient to the forward's
    placements.  DTensor's rule for the backward of a view that splits or
    merges a dim takes the gradient's placements as they come, and a
    gradient split over more ranks than the heads it views (from a
    projection split on its input dim, as in ``fsdp`` mode) gets a wrong
    local shape; after this it arrives as the view's output was placed."""

    @staticmethod
    def forward(ctx, x):
        # a pending sum's gradient is the same on every rank
        ctx.placements = tuple(Replicate() if p.is_partial() else p
                               for p in x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g


def reshape(y: torch.Tensor, *shape) -> torch.Tensor:
    """``y.reshape(*shape)``; a DTensor's gradient brought back as the
    result was placed (``_GradAsForward``)."""
    if not isinstance(y, DTensor):
        return y.reshape(*shape)
    return _GradAsForward.apply(y.reshape(*shape))


def split_heads(y: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """y (B, S, heads * head_dim) viewed as (B, S, heads, head_dim).  A
    DTensor whose last dim is split over more ranks than divide ``heads``
    is first gathered along it (the reference's resharding: two KV heads
    over four model ranks)."""
    B, S = y.shape[:2]
    if isinstance(y, DTensor):
        ways = math.prod(y.device_mesh.size(m) for m, p in
                         enumerate(y.placements) if p.is_shard(y.ndim - 1))
        if heads % ways:
            y = y.redistribute(y.device_mesh, rows_placements(y))
    return reshape(y, B, S, heads, head_dim)


def merge_heads(y: torch.Tensor) -> torch.Tensor:
    """y (B, S, heads, head_dim) as (B, S, heads * head_dim)."""
    return reshape(y, *y.shape[:2], -1)


def shard_index(mesh, pl: Sequence, dim: int) -> Tuple[int, int]:
    """(this rank's index among the shards of tensor dim ``dim`` under
    placements ``pl``, their number): mesh-dim order, the outer dim's
    chunks first, as DTensor splits."""
    index, count = 0, 1
    for m, p in enumerate(pl):
        if p.is_shard(dim):
            index = index * mesh.size(m) + mesh.get_local_rank(m)
            count *= mesh.size(m)
    return index, count


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``F.embedding(ids, table)``; on a DTensor table split by rows (the
    vocab over ``model``), each rank looks up its ids (their batch split
    kept, whole over the row split) in its rows, and the sums are pending
    (``Partial``) until the caller's ``shard``."""
    if not isinstance(table, DTensor):
        return F.embedding(ids, table)
    mesh = table.device_mesh
    rows = tuple(p if p.is_shard(0) else Replicate() for p in table.placements)
    first, _ = shard_index(mesh, rows, 0)

    def local(t, ids):
        n = t.shape[0]
        ids = ids - first * n
        hit = (ids >= 0) & (ids < n)
        return F.embedding(ids.clamp(0, n - 1), t) * hit[..., None].to(t.dtype)
    split = tuple(ids.placements)
    want = tuple(Replicate() if r.is_shard(0) or q.is_partial() else q
                 for r, q in zip(rows, split))
    out = tuple(Partial() if r.is_shard(0) else q
                for r, q in zip(rows, want))
    grad = tuple(r if r.is_shard(0) else Partial() if q.is_shard()
                 else Replicate() for r, q in zip(rows, want))
    return local_call(local, out, (table, ids), (rows, want), (grad, want))


def gathered(w: torch.Tensor) -> torch.Tensor:
    """A weight as a product uses it: a DTensor's split over the batch axes
    (``pod``, ``data``: FSDP) gathered, its ``model`` split kept; anything
    else as it is.  ZeRO-3's all-gather before use (the gradient goes back
    by reduce-scatter): left to itself, DTensor may rather split the
    activations along the contraction and leave the product's batch whole
    and pending on every rank."""
    if not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names
    want = tuple(Replicate() if names[m] in BATCH else p
                 for m, p in enumerate(w.placements))
    if want == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, want)


def full_value(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's full value (a collective: every rank of its mesh calls
    it); any other tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def replicated(t: torch.Tensor, like) -> torch.Tensor:
    """``t``, a tensor every rank computes alike, as a replicated DTensor on
    ``like``'s mesh when ``like`` is a DTensor; else ``t`` itself."""
    if not isinstance(like, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def param(t: torch.Tensor) -> torch.nn.Parameter:
    """A parameter, frozen: serving builds no autograd graph.  Training
    unfreezes a whole model (``Transformer(..., trainable=True)``)."""
    return torch.nn.Parameter(t, requires_grad=False)


def local_call(fn, out_placements, args, in_placements, grad_placements):
    """``fn`` on the local shards of ``args`` (``local_map``): each DTensor
    argument redistributed to its entry of ``in_placements`` (None for a
    non-tensor), the outputs DTensors of ``out_placements``; a
    ``grad_placements`` entry says how the local gradient of its argument
    is placed (``Partial`` where the argument is replicated over a mesh dim
    along which the call is split)."""
    from torch.distributed.tensor.experimental import local_map
    from torch.distributed.tensor.placement_types import Placement
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    if all(isinstance(p, Placement) for p in out_placements):
        out_placements = list(out_placements)     # one output
    return local_map(fn, out_placements=out_placements,
                     in_placements=tuple(in_placements),
                     in_grad_placements=tuple(grad_placements),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def rows_placements(x: DTensor, keep: int = 1) -> tuple:
    """x's placements with its last ``keep`` dims unsplit and nothing
    pending (a ``Shard`` of those dims or a ``Partial`` made
    ``Replicate``)."""
    return tuple(Replicate() if p.is_partial() or (
        p.is_shard() and p.dim % x.ndim >= x.ndim - keep) else p
        for p in x.placements)


def split_grads(pl: Sequence) -> tuple:
    """The placement of a replicated argument's gradient in a call split
    as ``pl``: partial where ``pl`` shards, replicated elsewhere."""
    return tuple(Partial() if p.is_shard() else Replicate() for p in pl)


def rowwise(fn, x: torch.Tensor, *vectors: torch.Tensor):
    """``fn(x, *vectors)`` for a function of each row (last dim) of x with
    replicated vectors; on a DTensor x, on its local rows."""
    if not isinstance(x, DTensor):
        return fn(x, *vectors)
    pl = rows_placements(x)
    rep = (Replicate(),) * len(pl)
    return local_call(fn, pl, (x,) + vectors, (pl,) + (rep,) * len(vectors),
                      (pl,) + (split_grads(pl),) * len(vectors))


def channelwise(fn, ref: torch.Tensor, args: Sequence, outs: Sequence):
    """``fn(*tensors)`` for a function that is independent across the batch
    (dim 0 of an activation) and across channels, and runs whole along
    time: the recurrent blocks' convolutions and scans.  ``args``: (tensor
    or None, is an activation, its channel dim or None for a tensor every
    channel reads) each; ``outs``: (ndim, channel dim) of each output.  On
    a DTensor ``ref`` (an activation, the channels its last dim), on local
    shards: the batch split as ``ref``'s, the channels split where
    ``ref``'s are, anything else (the time) gathered; the gradient of an
    argument is partial over a split it is replicated across."""
    tensors = [a for a, _, _ in args]
    if not isinstance(ref, DTensor):
        return fn(*tensors)
    roles = ["batch" if p.is_shard(0) else "chan" if p.is_shard(ref.ndim - 1)
             else None for p in ref.placements]

    def pl(ndim, chan, act, grad=False):
        return tuple(Shard(0) if r == "batch" and act
                     else Shard(chan % ndim) if r == "chan" and chan is not None
                     else Partial() if r is not None and grad
                     else Replicate() for r in roles)
    ins = [None if a is None else pl(a.ndim, c, act) for a, act, c in args]
    grads = [None if a is None else pl(a.ndim, c, act, grad=True)
             for a, act, c in args]
    out = [pl(n, c, True) for n, c in outs]
    return local_call(fn, out[0] if len(out) == 1 else tuple(out), tensors,
                      ins, grads)


def rmsnorm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-6):
    """``x * rsqrt(mean(x^2) + eps) * w`` in fp32, cast to x's dtype."""
    return rowwise(lambda x, w: fused_rmsnorm(x, w, eps=eps), x, w)


def _layernorm(x, scale, bias, eps):
    y = F.layer_norm(x.float(), x.shape[-1:], scale.float(), bias.float(),
                     eps)
    return y.to(x.dtype)


def layernorm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
              eps: float = 1e-5):
    """``(x - mean) * rsqrt(var + eps) * scale + bias`` over the last axis,
    in fp32 (scale and bias too), cast to x's dtype."""
    return rowwise(lambda x, s, b: _layernorm(x, s, b, eps), x, scale, bias)


# ---- initializers (the reference's scheme, drawn from a torch.Generator) ----

def dense_init(d_in: int, d_out: int, dtype, device,
               generator) -> torch.Tensor:
    """(d_in, d_out) weight, normal with std 1/sqrt(d_in), in ``x @ w``
    layout as the reference keeps it."""
    w = torch.randn(d_in, d_out, device=device, generator=generator)
    return (w / math.sqrt(d_in)).to(dtype)


def embed_init(vocab: int, d: int, dtype, device, generator) -> torch.Tensor:
    w = torch.randn(vocab, d, device=device, generator=generator)
    return (w * 0.02).to(dtype)


# ---- rotary position embeddings ----

def rope_freqs(head_dim: int, fraction: float, theta: float,
               device=None) -> Tuple[torch.Tensor, int]:
    """Inverse frequencies of a (possibly partial) rotary embedding, and the
    number of rotated dims."""
    rot = int(head_dim * fraction) // 2 * 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** exps), rot


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               fraction: float = 1.0, theta: float = 10_000.0):
    """x: (..., S, H, head_dim); positions: (S,) or broadcastable to (..., S).

    Rotates the first ``rot`` dims by the half-split rule (not interleaved),
    with the angles in fp32, and casts the rotated part back to x's dtype.
    """
    inv, rot = rope_freqs(x.shape[-1], fraction, theta, device=x.device)
    if rot == 0:
        return x
    ang = positions[..., :, None].float() * inv        # (..., S, rot/2)
    sin = replicated(torch.sin(ang)[..., :, None, :], x)  # (..., S, 1, rot/2)
    cos = replicated(torch.cos(ang)[..., :, None, :], x)
    x1, x2, xp = x[..., :rot // 2], x[..., rot // 2:rot], x[..., rot:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


# ---- activations ----

def act_fn(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]
