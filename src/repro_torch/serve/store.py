"""Content-addressed, on-disk schedule store (the port's copy of
``repro/serve/store.py``: the same keys, bit for bit, and the same layout,
so the reference's store and the port's serve each other's objects).

An :class:`ArtifactStore` holds finished
:class:`~repro_torch.search.artifact.ScheduleArtifact`s keyed by *what was
searched*: the sha256 of the canonical :class:`~repro_torch.search.spec.
SearchSpec` JSON combined with the structural fingerprint of the graph it
ran on.  Identical requests therefore address the same object — a repeat
search is a read, not a re-search — while any change to the spec (seed,
backend config, cost model, ...) or to the workload's structure addresses
a different one.

Layout (``root/``)::

    store.json                  # {"store_version": 1}
    objects/<kk>/<key>.json     # one ScheduleArtifact JSON per object,
                                # sharded by the key's first two hex chars

Durability rules:

* **atomic writes** — objects are written to a temp file in the target
  directory and ``os.replace``d into place, so readers (and concurrent
  writers of the same key) never observe a torn object;
* **versioned schema** — ``store.json`` pins the layout version; objects
  are plain ``ScheduleArtifact`` JSON (self-versioned via their
  ``version`` field), so ``report`` (either package's CLI) reads them and
  artifacts written by older builds (pre cost-breakdown schema) load
  leniently with warnings instead of failing the store.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Dict, Iterator, Optional

from repro_torch.search.artifact import ScheduleArtifact
from repro_torch.search.spec import SearchSpec

STORE_VERSION = 1


class StoreError(ValueError):
    """The store layout/object is unusable (wrong version, corrupt object,
    or an object whose content does not match its key)."""


def spec_hash(spec: SearchSpec) -> str:
    """sha256 of the spec's canonical JSON (sorted keys, compact
    separators) — the request half of the store key."""
    blob = json.dumps(spec.to_dict(), sort_keys=True,
                      separators=(",", ":"), default=list)
    return hashlib.sha256(blob.encode()).hexdigest()


def artifact_key(graph_fingerprint: str, spec: SearchSpec) -> str:
    """The store key: sha256 over (graph fingerprint, canonical spec
    hash).  Content-addressed — no counters, no registration order.

    ``file:``/``ir:`` workload specs are normalized to
    ``ir:<fingerprint>`` before hashing: the graph fingerprint already
    pins the content, so the same model submitted under two filenames
    (or re-exported elsewhere) addresses one object instead of paying a
    second search."""
    if spec.workload.startswith(("file:", "ir:")):
        spec = spec.replace(workload=f"ir:{graph_fingerprint}",
                            workload_kwargs={})
    blob = f"{graph_fingerprint}\n{spec_hash(spec)}"
    return hashlib.sha256(blob.encode()).hexdigest()


def _atomic_write(path: str, text: str) -> None:
    """Write-then-rename in ``path``'s directory: concurrent writers of the
    same path race benignly (last replace wins, both contents are whole)."""
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-", suffix=".json")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class ArtifactStore:
    """On-disk map ``(graph fingerprint, spec) -> ScheduleArtifact``.

    Safe for concurrent writers (atomic object writes; the layout needs no
    central index).  Hit/miss/put counters accumulate on the live instance
    for service stats.
    """

    def __init__(self, root: str, *, create: bool = True):
        self.root = root
        self.objects_dir = os.path.join(root, "objects")
        self.hits = 0
        self.misses = 0
        self.puts = 0
        meta_path = os.path.join(root, "store.json")
        if os.path.isfile(meta_path):
            with open(meta_path) as f:
                try:
                    meta = json.load(f)
                except json.JSONDecodeError as e:
                    raise StoreError(f"corrupt store meta {meta_path}: {e}") \
                        from None
            v = meta.get("store_version")
            if v != STORE_VERSION:
                raise StoreError(
                    f"store {root} has layout version {v!r}; this build "
                    f"reads version {STORE_VERSION}")
        elif create:
            os.makedirs(self.objects_dir, exist_ok=True)
            _atomic_write(meta_path,
                          json.dumps({"store_version": STORE_VERSION},
                                     sort_keys=True) + "\n")
        else:
            raise StoreError(f"no store at {root} (pass create=True)")

    # ---- addressing -------------------------------------------------------------
    def path_for(self, key: str) -> str:
        return os.path.join(self.objects_dir, key[:2], f"{key}.json")

    # ---- reads ------------------------------------------------------------------
    def get(self, graph_fingerprint: str, spec: SearchSpec
            ) -> Optional[ScheduleArtifact]:
        """The stored artifact for this exact request, or None (a miss).
        Corrupt objects and key/content mismatches raise :class:`StoreError`
        — a store that silently serves the wrong schedule is worse than one
        that fails loudly."""
        key = artifact_key(graph_fingerprint, spec)
        art = self.load_key(key)
        if art is None:
            self.misses += 1
            return None
        # recompute the stored spec's canonical key rather than comparing
        # raw spec hashes: file: specs under different paths are the same
        # request when their graphs fingerprint identically
        if art.graph_fingerprint != graph_fingerprint or \
                artifact_key(art.graph_fingerprint, art.spec) != key:
            raise StoreError(
                f"store object {key} does not match its key (expected "
                f"fingerprint {graph_fingerprint}, spec {spec.to_dict()}); "
                f"the object was corrupted or hand-edited")
        self.hits += 1
        # LRU access clock for the reference's ``repro store gc``: a served
        # hit refreshes the object's mtime so eviction age means "time since
        # last use", not "time since creation"; best-effort (read-only
        # stores still serve)
        try:
            os.utime(self.path_for(key))
        except OSError:
            pass
        return art

    def load_key(self, key: str) -> Optional[ScheduleArtifact]:
        """Load one object by key (no hit/miss accounting, no content
        check); None when absent."""
        path = self.path_for(key)
        try:
            with open(path) as f:
                text = f.read()
        except FileNotFoundError:
            return None
        try:
            return ScheduleArtifact.from_json(text)
        except (ValueError, KeyError, TypeError) as e:
            raise StoreError(f"corrupt store object {path}: {e}") from None

    def contains(self, graph_fingerprint: str, spec: SearchSpec) -> bool:
        return os.path.isfile(
            self.path_for(artifact_key(graph_fingerprint, spec)))

    # ---- writes -----------------------------------------------------------------
    def put(self, artifact: ScheduleArtifact) -> str:
        """Store an artifact under its content key (atomic; idempotent —
        re-putting the same request overwrites with equivalent content).
        Returns the key."""
        key = artifact_key(artifact.graph_fingerprint, artifact.spec)
        path = self.path_for(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        _atomic_write(path, artifact.to_json())
        self.puts += 1
        return key

    # ---- enumeration / stats ----------------------------------------------------
    def keys(self) -> Iterator[str]:
        if not os.path.isdir(self.objects_dir):
            return
        for shard in sorted(os.listdir(self.objects_dir)):
            d = os.path.join(self.objects_dir, shard)
            if not os.path.isdir(d):
                continue
            for name in sorted(os.listdir(d)):
                if name.endswith(".json") and not name.startswith(".tmp-"):
                    yield name[:-len(".json")]

    def __len__(self) -> int:
        return sum(1 for _ in self.keys())

    def stats(self) -> Dict[str, int]:
        return {"objects": len(self), "hits": self.hits,
                "misses": self.misses, "puts": self.puts}
