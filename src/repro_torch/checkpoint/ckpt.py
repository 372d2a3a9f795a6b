"""Fault-tolerant checkpointing: atomic, checksummed, async, in the
reference's on-disk format.

Counterpart: ``repro/checkpoint/ckpt.py``.  A checkpoint is a directory
``step_XXXXXXXX/`` of one ``.npy`` buffer a leaf and a ``manifest.json``
listing each leaf's ``name``, ``file``, ``crc32`` (of the bytes on disk),
``shape``, ``dtype`` and ``codec``:

* **Atomicity**: written to ``step_N.tmp/``, each file fsynced, then renamed
  to ``step_N/``; a crash mid-save never corrupts the latest checkpoint.
* **Integrity**: every buffer's crc32 is checked on load.
* **Async**: ``CheckpointManager.save_async`` copies every leaf to host
  memory synchronously, then writes on a background thread.
* **Retention**: the newest ``keep`` checkpoints stay; older ones go only
  after the newer save committed.

A tree is a nested dict (or list) of tensors.  Leaf names
are the reference's: the ``/``-joined path of dict keys and list indices,
the keys visited in sorted order as ``jax.tree_util`` visits them (so the
files are numbered as the reference numbers them).  bf16 is stored as a
``uint16`` view with ``"bfloat16"`` in the manifest, as the reference
stores it, and read back as ``torch.bfloat16`` without ``ml_dtypes``.  The
port writes codec ``raw`` (no ``zstandard`` is needed to write); it reads
``zstd`` buffers when ``zstandard`` can be imported and otherwise raises an
error naming the codec.  A checkpoint written by either package loads in
the other (``repro_torch.convert.params_to_jax`` gives a model's params the
reference's tree).  The format knows no mesh: a DTensor leaf is saved as its
full value, and a ``tree_like`` DTensor leaf gets its rank's slice of the
loaded value, on whatever mesh it lives; a ``tree_like`` meta leaf (a
shape and a dtype) gets the loaded value on the host.
"""
from __future__ import annotations

import io
import json
import os
import shutil
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.common import full_value, local_slice

_MANIFEST = "manifest.json"

# logical dtype name -> (torch dtype, the integer numpy type it is stored as)
_EXOTIC_STORE = {"bfloat16": (torch.bfloat16, np.uint16)}


def _host(leaf: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array (bf16 as its uint16 view), without
    copying a CPU tensor; a DTensor's full value."""
    t = full_value(leaf).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _logical(leaf: torch.Tensor) -> str:
    return str(leaf.dtype).removeprefix("torch.")


def _flatten(tree, prefix: Tuple = ()) -> List[Tuple[str, Any]]:
    """(name, leaf) in the reference's order: dict keys sorted, list and
    tuple items by index."""
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [("/".join(str(k) for k in prefix), tree)]
    out = []
    for k, v in items:
        out.extend(_flatten(v, prefix + (k,)))
    return out


def _unflatten_like(tree, leaves: Dict[str, Any], prefix: Tuple = ()):
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, leaves, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten_like(v, leaves, prefix + (i,))
                          for i, v in enumerate(tree))
    return leaves["/".join(str(k) for k in prefix)]


def save_checkpoint(directory: str, step: int, tree, *,
                    keep: int = 3) -> str:
    """Synchronous atomic save (codec ``raw``).  Returns the committed
    path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": []}
    for i, (name, leaf) in enumerate(_flatten(tree)):
        arr = _host(leaf)
        buf = io.BytesIO()
        np.save(buf, arr)
        raw = buf.getvalue()
        fname = f"leaf_{i:05d}.npy"
        with open(os.path.join(tmp, fname), "wb") as f:
            f.write(raw)
            f.flush()
            os.fsync(f.fileno())
        manifest["leaves"].append({
            "name": name, "file": fname, "crc32": zlib.crc32(raw),
            "shape": list(arr.shape), "dtype": _logical(leaf),
            "codec": "raw"})
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _retain(directory, keep)
    return final


def _retain(directory: str, keep: int):
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(directory, d, _MANIFEST))]
    return max(steps) if steps else None


def _decode(raw: bytes, codec: str, name: str) -> np.ndarray:
    if codec == "zstd":
        try:
            import zstandard
        except ImportError as e:
            raise RuntimeError(
                f"{name}: codec 'zstd' needs the zstandard package, which "
                f"is not installed") from e
        raw = zstandard.ZstdDecompressor().decompress(raw)
    elif codec != "raw":
        raise ValueError(f"{name}: unknown codec {codec!r}")
    return np.load(io.BytesIO(raw), allow_pickle=False)


def _tensor(arr: np.ndarray, logical: str) -> torch.Tensor:
    if logical in _EXOTIC_STORE:
        dt, store = _EXOTIC_STORE[logical]
        return torch.from_numpy(arr.astype(store, copy=False)
                                .view(np.int16)).view(dt)
    return torch.from_numpy(arr if arr.flags.c_contiguous else arr.copy())


def load_checkpoint(directory: str, tree_like, step: Optional[int] = None):
    """Restore into the structure of ``tree_like`` (a tree of tensors).
    Returns (tree of tensors, each cast to its ``tree_like`` leaf's dtype
    and on its device, a meta leaf's on the host, step)."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    by_name = {m["name"]: m for m in manifest["leaves"]}
    out = {}
    for name, like in _flatten(tree_like):
        meta = by_name[name]
        with open(os.path.join(path, meta["file"]), "rb") as f:
            raw = f.read()
        if zlib.crc32(raw) != meta["crc32"]:
            raise IOError(f"checksum mismatch for {name} in {path}")
        t = _tensor(_decode(raw, meta.get("codec", "raw"), name),
                    meta["dtype"])
        if list(t.shape) != list(like.shape):
            raise ValueError(f"shape mismatch for {name}: "
                             f"ckpt {tuple(t.shape)} vs expected "
                             f"{tuple(like.shape)}")
        t = t.to(device="cpu" if like.is_meta else like.device,
                 dtype=like.dtype)
        if isinstance(like, DTensor):     # this rank's slices, any mesh
            t = DTensor.from_local(
                local_slice(t, like.device_mesh, like.placements),
                like.device_mesh, like.placements, run_check=False)
        out[name] = t
    return _unflatten_like(tree_like, out), step


class CheckpointManager:
    """Async wrapper: snapshot to host memory synchronously, persist in the
    background."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save_async(self, step: int, tree):
        """Copies every leaf to host memory before returning (a later
        in-place update of a leaf does not reach the file), then writes on a
        thread."""
        self.wait()
        host_tree = _unflatten_like(tree, {
            name: full_value(leaf).detach().to("cpu", copy=True)
            for name, leaf in _flatten(tree)})

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree,
                                keep=self.keep)
            except BaseException as e:     # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def restore(self, tree_like):
        return load_checkpoint(self.directory, tree_like)
