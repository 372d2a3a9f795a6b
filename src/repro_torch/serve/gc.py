"""Store garbage collection: LRU-by-access eviction with live-job pins.

``repro store gc --store DIR [--max-objects N] [--max-bytes B]`` trims an
:class:`~repro_torch.serve.store.ArtifactStore` down to the given limits by
deleting the least-recently-*used* objects first (the store refreshes an
object's mtime on every served hit, so mtime order is access order).

Safety rules:

* objects referenced by queued/running daemon jobs (the queue journal's
  :meth:`~repro_torch.serve.queue.JobQueue.live_keys`) are **never** evicted,
  even when that leaves the store over its limits;
* unreadable or corrupt objects are *reported*, never silently deleted
  and never a crash — a GC run must not destroy evidence of corruption;
* deletion is per-object file removal (the layout has no central index
  to rewrite), so an interrupted GC leaves a smaller, still-valid store.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import AbstractSet, Dict, List, Optional, Tuple

from repro_torch.serve.queue import QUEUE_FILE, JobQueue
from repro_torch.serve.store import ArtifactStore, StoreError


@dataclass
class GCResult:
    """What one GC pass examined and removed."""

    examined: int = 0
    bytes_total: int = 0               # store size before eviction
    evicted: List[str] = field(default_factory=list)
    evicted_bytes: int = 0
    kept_live: List[str] = field(default_factory=list)   # pinned by jobs
    corrupt: List[str] = field(default_factory=list)     # reported only
    dry_run: bool = False

    def to_dict(self) -> Dict[str, object]:
        return {
            "examined": self.examined,
            "bytes_total": self.bytes_total,
            "evicted": list(self.evicted),
            "evicted_bytes": self.evicted_bytes,
            "kept_live": list(self.kept_live),
            "corrupt": list(self.corrupt),
            "bytes_after": self.bytes_total - self.evicted_bytes,
            "objects_after": self.examined - len(self.evicted),
            "dry_run": self.dry_run,
        }


def live_keys_for_store(root: str) -> AbstractSet[str]:
    """Keys pinned by the store's queue journal (queued/running jobs);
    empty when no daemon has ever journaled there."""
    if not os.path.isfile(os.path.join(root, QUEUE_FILE)):
        return frozenset()
    queue = JobQueue(root)
    try:
        return queue.live_keys()
    finally:
        queue.close()


def collect_garbage(store: ArtifactStore, *,
                    max_objects: Optional[int] = None,
                    max_bytes: Optional[int] = None,
                    live: Optional[AbstractSet[str]] = None,
                    dry_run: bool = False) -> GCResult:
    """Evict least-recently-used objects until the store fits
    ``max_objects`` / ``max_bytes`` (whichever are given).  ``live`` keys
    are never evicted; corrupt objects are reported and left in place
    (they still count toward the totals, so a store can legitimately end
    over-limit — the report says why)."""
    live = live if live is not None else live_keys_for_store(store.root)
    result = GCResult(dry_run=dry_run)
    entries: List[Tuple[float, int, str]] = []      # (mtime, size, key)
    for key in store.keys():
        path = store.path_for(key)
        try:
            st = os.stat(path)
        except OSError:
            result.corrupt.append(key)
            continue
        result.examined += 1
        result.bytes_total += st.st_size
        try:
            store.load_key(key)
        except StoreError:
            result.corrupt.append(key)
            continue                     # reported, never auto-deleted
        if key in live:
            result.kept_live.append(key)
            continue
        entries.append((st.st_mtime, st.st_size, key))
    entries.sort()                       # oldest access first
    objects_now = result.examined
    bytes_now = result.bytes_total
    for mtime, size, key in entries:
        over_objects = max_objects is not None and objects_now > max_objects
        over_bytes = max_bytes is not None and bytes_now > max_bytes
        if not (over_objects or over_bytes):
            break
        if not dry_run:
            try:
                os.unlink(store.path_for(key))
            except OSError:
                result.corrupt.append(key)
                continue
        result.evicted.append(key)
        result.evicted_bytes += size
        objects_now -= 1
        bytes_now -= size
    return result
