"""Span-scoped JSONL tracer: schema-versioned events, one per line.

Event schema (``v`` = :data:`SCHEMA_VERSION`):

completed span (written once, when the span closes)::

    {"v": 1, "pid": 123, "ev": "span", "name": "batch_eval", "id": 7,
     "parent": 3, "t0": 1700000000.1, "dur_s": 0.004, "attrs": {...}}

point event (instantaneous)::

    {"v": 1, "pid": 123, "ev": "point", "name": "island.migration",
     "parent": 3, "ts": 1700000000.2, "attrs": {...}}

Span ids come from one process-wide counter, so several tracers (or the
same tracer reached from several threads) never collide; a forked child
keeps writing to the inherited descriptor with its own ``pid``, so span
identity across a whole trace file is ``(pid, id)``.  Every event is
written-and-flushed as a single line, which keeps multi-process appends
intact in practice (lines are far below the pipe/page atomicity sizes).

Nesting is by ``parent`` id.  The tracer keeps an explicit ambient stack —
``span()`` is the context-manager convenience; instrumentation that needs
to close spans retroactively (the per-generation windows in
``SearchSession``) drives ``alloc_id``/``push``/``pop``/``emit_span``
directly.  :data:`NULL_TRACER` is the disabled-path singleton: every method
is a no-op and ``span()`` hands back one shared, reusable null context.

``repro trace <file.jsonl>`` (``repro_torch.obs.traceview``) validates and
aggregates these files; :func:`validate_event` is the schema authority.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
from typing import Any, Dict, List, Optional

from repro_torch.obs import clock

SCHEMA_VERSION = 1

#: process-wide span id source (thread-safe in CPython; forked children
#: inherit the count position but differ in pid, so (pid, id) stays unique)
_span_ids = itertools.count(1)

_SPAN_KEYS = {"v", "pid", "ev", "name", "id", "parent", "t0", "dur_s",
              "attrs"}
_POINT_KEYS = {"v", "pid", "ev", "name", "parent", "ts", "attrs"}

#: sentinel: "parent defaults to the tracer's current ambient span"
_AMBIENT = object()


def validate_event(obj: Any) -> List[str]:
    """Schema-check one decoded JSONL event; returns the list of
    violations (empty = valid).  Strict about key sets so schema drift
    forces a ``v`` bump instead of silently passing."""
    if not isinstance(obj, dict):
        return ["event is not a JSON object"]
    errs: List[str] = []
    if obj.get("v") != SCHEMA_VERSION:
        errs.append(f"v={obj.get('v')!r} (this build reads "
                    f"v={SCHEMA_VERSION})")
    if not isinstance(obj.get("pid"), int) or isinstance(obj.get("pid"),
                                                         bool):
        errs.append("pid must be an integer")
    ev = obj.get("ev")
    if ev not in ("span", "point"):
        errs.append(f"ev={ev!r} (must be 'span' or 'point')")
        return errs
    name = obj.get("name")
    if not isinstance(name, str) or not name:
        errs.append("name must be a non-empty string")
    parent = obj.get("parent")
    if parent is not None and (not isinstance(parent, int)
                               or isinstance(parent, bool) or parent < 1):
        errs.append("parent must be null or a positive integer")
    attrs = obj.get("attrs")
    if not isinstance(attrs, dict):
        errs.append("attrs must be an object")
    allowed = _SPAN_KEYS if ev == "span" else _POINT_KEYS
    extra = sorted(set(obj) - allowed)
    if extra:
        errs.append(f"unknown keys {extra} (schema v{SCHEMA_VERSION})")
    if ev == "span":
        sid = obj.get("id")
        if not isinstance(sid, int) or isinstance(sid, bool) or sid < 1:
            errs.append("span id must be a positive integer")
        if not isinstance(obj.get("t0"), (int, float)):
            errs.append("t0 must be a number")
        dur = obj.get("dur_s")
        if not isinstance(dur, (int, float)) or dur < 0:
            errs.append("dur_s must be a non-negative number")
    else:
        if not isinstance(obj.get("ts"), (int, float)):
            errs.append("ts must be a number")
    return errs


class _NullSpan:
    """Reusable no-op context manager (one shared instance)."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """Context manager behind :meth:`Tracer.span`."""

    __slots__ = ("_tracer", "_name", "_attrs", "_id", "_parent", "_t0",
                 "_p0")

    def __init__(self, tracer: "Tracer", name: str,
                 attrs: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs

    def __enter__(self) -> int:
        tr = self._tracer
        self._parent = tr.current()
        self._id = tr.alloc_id()
        self._t0 = clock.now()
        self._p0 = clock.perf_counter()
        tr.push(self._id)
        return self._id

    def __exit__(self, *exc) -> bool:
        tr = self._tracer
        tr.pop()
        tr.emit_span(self._name, t0=self._t0,
                     dur_s=clock.perf_counter() - self._p0,
                     span_id=self._id, parent=self._parent,
                     attrs=self._attrs)
        return False


class Tracer:
    """JSONL event writer with an ambient span stack."""

    enabled = True

    def __init__(self, path: Optional[str] = None, *, stream=None):
        if stream is not None:
            self._f = stream
            self._own = False
        elif path is not None:
            self._f = open(path, "a")
            self._own = True
        else:
            raise ValueError("Tracer needs a path or a stream")
        self._lock = threading.Lock()
        self._stack: List[int] = []

    # ---- ambient span stack -----------------------------------------------------
    def alloc_id(self) -> int:
        return next(_span_ids)

    def push(self, span_id: int) -> None:
        self._stack.append(span_id)

    def pop(self) -> Optional[int]:
        return self._stack.pop() if self._stack else None

    def current(self) -> Optional[int]:
        return self._stack[-1] if self._stack else None

    # ---- emission ---------------------------------------------------------------
    def _write(self, obj: Dict[str, Any]) -> None:
        line = json.dumps(obj, sort_keys=True, separators=(",", ":"))
        with self._lock:
            self._f.write(line + "\n")
            self._f.flush()              # one line per write: fork/append-safe

    def emit_span(self, name: str, *, t0: float, dur_s: float,
                  span_id: Optional[int] = None, parent: Any = _AMBIENT,
                  attrs: Optional[Dict[str, Any]] = None) -> int:
        """Write one completed span.  ``span_id`` lets callers that
        pre-allocated the id (so children could nest under it while it was
        open) close it retroactively; ``parent`` defaults to the current
        ambient span."""
        if span_id is None:
            span_id = self.alloc_id()
        if parent is _AMBIENT:
            parent = self.current()
        self._write({
            "v": SCHEMA_VERSION, "pid": os.getpid(), "ev": "span",
            "name": name, "id": span_id, "parent": parent,
            "t0": t0, "dur_s": dur_s, "attrs": attrs or {}})
        return span_id

    def point(self, name: str, *, parent: Any = _AMBIENT,
              attrs: Optional[Dict[str, Any]] = None) -> None:
        """Write one instantaneous event."""
        if parent is _AMBIENT:
            parent = self.current()
        self._write({
            "v": SCHEMA_VERSION, "pid": os.getpid(), "ev": "point",
            "name": name, "parent": parent, "ts": clock.now(),
            "attrs": attrs or {}})

    def span(self, name: str,
             attrs: Optional[Dict[str, Any]] = None) -> _Span:
        """``with tracer.span("search"):`` — opens on enter, emits the
        completed span on exit."""
        return _Span(self, name, attrs)

    def close(self) -> None:
        if self._own:
            self._f.close()


class NullTracer:
    """Disabled-path tracer: every operation is a no-op.  One shared
    instance (:data:`NULL_TRACER`); check ``.enabled`` before building
    attrs dicts on hot paths."""

    enabled = False

    def alloc_id(self) -> int:
        return 0

    def push(self, span_id: int) -> None:
        pass

    def pop(self) -> Optional[int]:
        return None

    def current(self) -> Optional[int]:
        return None

    def emit_span(self, name: str, **kw) -> int:
        return 0

    def point(self, name: str, **kw) -> None:
        pass

    def span(self, name: str, attrs=None) -> _NullSpan:
        return _NULL_SPAN

    def close(self) -> None:
        pass


NULL_TRACER = NullTracer()
