"""Aggregate a JSONL trace file (the ``repro trace`` verb).

Reads every line, validates it against the event schema
(:func:`repro_torch.obs.trace.validate_event`), and rolls the events up into:

* the **span tree** — spans grouped by their name-path (parents resolved
  via ``(pid, id)``; spans whose parent never closed, e.g. forked-worker
  children of an unemitted window, root at their own name), with count /
  total / max duration per path;
* the **top-k slowest spans**;
* **metric rollups** — every ``metrics.snapshot`` point merged (counters
  summed, gauges last-wins, histograms combined), plus per-name point
  counts.

A file with any invalid line still aggregates (the bad lines are listed),
but ``valid`` is False and the CLI exits non-zero.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.obs.trace import validate_event

#: parent-chain depth bound (defends path building against id cycles in a
#: hand-edited file; real traces nest search > generation > batch > cost)
_MAX_DEPTH = 64


@dataclass
class TraceReport:
    """The aggregate ``repro trace`` renders."""

    path: str
    n_events: int = 0
    n_spans: int = 0
    n_points: int = 0
    errors: List[str] = field(default_factory=list)
    span_counts: Dict[str, int] = field(default_factory=dict)
    tree: List[Dict[str, Any]] = field(default_factory=list)
    slowest: List[Dict[str, Any]] = field(default_factory=list)
    point_counts: Dict[str, int] = field(default_factory=dict)
    metrics: Dict[str, Any] = field(default_factory=dict)

    @property
    def valid(self) -> bool:
        return not self.errors

    def to_dict(self) -> Dict[str, Any]:
        return {
            "path": self.path,
            "valid": self.valid,
            "n_events": self.n_events,
            "n_spans": self.n_spans,
            "n_points": self.n_points,
            "errors": self.errors,
            "span_counts": self.span_counts,
            "tree": self.tree,
            "slowest": self.slowest,
            "point_counts": self.point_counts,
            "metrics": self.metrics,
        }

    def describe(self) -> str:
        lines = [f"{self.path}: {self.n_events} events "
                 f"({self.n_spans} spans, {self.n_points} points) — "
                 + ("schema valid"
                    if self.valid else f"{len(self.errors)} INVALID line(s)")]
        for e in self.errors[:10]:
            lines.append(f"  error: {e}")
        if len(self.errors) > 10:
            lines.append(f"  ... and {len(self.errors) - 10} more")
        if self.tree:
            lines.append("span tree (count, total s, max s):")
            for row in self.tree:
                depth = row["path"].count("/")
                name = row["path"].rsplit("/", 1)[-1]
                lines.append(f"  {'  ' * depth}{name:<24} "
                             f"x{row['count']:<6} "
                             f"{row['total_s']:>9.4f}s  "
                             f"max {row['max_s']:.4f}s")
        if self.slowest:
            lines.append(f"slowest {len(self.slowest)} span(s):")
            for s in self.slowest:
                lines.append(f"  {s['dur_s']:>9.4f}s  {s['name']} "
                             f"(pid {s['pid']}, id {s['id']})")
        if self.point_counts:
            lines.append("points: " + "  ".join(
                f"{k} x{v}" for k, v in sorted(self.point_counts.items())))
        counters = self.metrics.get("counters", {})
        if counters:
            lines.append("metric rollup (counters):")
            for k, v in sorted(counters.items()):
                lines.append(f"  {k:<36} {v}")
        return "\n".join(lines)


def _merge_snapshot(acc: Dict[str, Any], snap: Dict[str, Any]) -> None:
    """Fold one ``metrics.snapshot`` point into the rollup: counters sum
    (per-process registries are disjoint streams), gauges last-wins,
    histograms combine."""
    for name, v in snap.get("counters", {}).items():
        if isinstance(v, (int, float)):
            acc["counters"][name] = acc["counters"].get(name, 0) + v
    for name, v in snap.get("gauges", {}).items():
        acc["gauges"][name] = v
    for name, h in snap.get("histograms", {}).items():
        if not isinstance(h, dict):
            continue
        cur = acc["histograms"].get(name)
        if cur is None:
            acc["histograms"][name] = dict(h)
            continue
        cur["count"] = cur.get("count", 0) + h.get("count", 0)
        cur["total"] = cur.get("total", 0.0) + h.get("total", 0.0)
        if h.get("count"):
            cur["min"] = min(cur.get("min", h["min"]), h["min"])
            cur["max"] = max(cur.get("max", h["max"]), h["max"])
        cur["mean"] = cur["total"] / cur["count"] if cur["count"] else 0.0
        buckets = cur.setdefault("buckets", {})
        for b, n in h.get("buckets", {}).items():
            buckets[b] = buckets.get(b, 0) + n


def read_trace(path: str, top: int = 10) -> TraceReport:
    """Parse, validate, and aggregate one trace file."""
    report = TraceReport(path=path)
    spans: Dict[Tuple[int, int], Dict[str, Any]] = {}
    metrics: Dict[str, Any] = {"counters": {}, "gauges": {},
                               "histograms": {}}
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                report.errors.append(f"line {lineno}: not JSON: {e.msg}")
                continue
            errs = validate_event(obj)
            if errs:
                report.errors.append(
                    f"line {lineno}: " + "; ".join(errs))
                continue
            report.n_events += 1
            if obj["ev"] == "span":
                report.n_spans += 1
                spans[(obj["pid"], obj["id"])] = obj
            else:
                report.n_points += 1
                name = obj["name"]
                report.point_counts[name] = \
                    report.point_counts.get(name, 0) + 1
                if name == "metrics.snapshot":
                    _merge_snapshot(metrics, obj.get("attrs", {}))
    report.metrics = metrics

    def name_path(span: Dict[str, Any]) -> str:
        parts = [span["name"]]
        pid, parent = span["pid"], span.get("parent")
        for _ in range(_MAX_DEPTH):
            if parent is None:
                break
            up = spans.get((pid, parent))
            if up is None:               # parent never emitted: root here
                break
            parts.append(up["name"])
            parent = up.get("parent")
        return "/".join(reversed(parts))

    paths: Dict[str, Dict[str, Any]] = {}
    for span in spans.values():
        report.span_counts[span["name"]] = \
            report.span_counts.get(span["name"], 0) + 1
        p = name_path(span)
        row = paths.get(p)
        if row is None:
            row = paths[p] = {"path": p, "count": 0, "total_s": 0.0,
                              "max_s": 0.0}
        row["count"] += 1
        row["total_s"] += span["dur_s"]
        if span["dur_s"] > row["max_s"]:
            row["max_s"] = span["dur_s"]
    for row in paths.values():
        row["total_s"] = round(row["total_s"], 6)
        row["max_s"] = round(row["max_s"], 6)
    report.tree = [paths[p] for p in sorted(paths)]
    report.slowest = [
        {"name": s["name"], "pid": s["pid"], "id": s["id"],
         "dur_s": round(s["dur_s"], 6), "attrs": s.get("attrs", {})}
        for s in sorted(spans.values(), key=lambda s: -s["dur_s"])[:top]]
    return report
