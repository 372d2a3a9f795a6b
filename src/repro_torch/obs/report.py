"""Render an artifact's embedded ``telemetry`` summary (``repro report
--telemetry``) — from the artifact alone, no trace file needed."""
from __future__ import annotations

from typing import Any, Dict, List

#: rows rendered before the curve is downsampled (evenly, endpoints kept)
_MAX_ROWS = 20
_BAR_W = 32


def _sample(n: int, k: int) -> List[int]:
    """Up to ``k`` indices out of ``n``, evenly spaced, first/last kept."""
    if n <= k:
        return list(range(n))
    idx = {round(i * (n - 1) / (k - 1)) for i in range(k)}
    return sorted(idx)


def render_telemetry(summary: Dict[str, Any]) -> str:
    """The convergence curve + cache stats, as fixed-width text."""
    steps = summary.get("steps", 0)
    best = summary.get("best", [])
    mean = summary.get("mean", [])
    rej = summary.get("rejection_rate", [])
    hit = summary.get("group_hit_rate", [])
    uniq = summary.get("unique_states", [])
    lines: List[str] = []
    if not steps or not best:
        return "telemetry    : summary present but carries no " \
               "per-generation records"
    lines.append(
        f"telemetry    : {steps} steps, best {best[0]:.4f} -> "
        f"{best[-1]:.4f}"
        + (f", {uniq[-1]} unique states" if uniq else ""))
    lo, hi = min(best), max(best)
    span = (hi - lo) or 1.0
    lines.append("convergence  :   step      best      mean   rej%  hit%")
    for i in _sample(len(best), _MAX_ROWS):
        bar = "#" * max(1, round((best[i] - lo) / span * _BAR_W))
        lines.append(
            f"               {i:>6}  {best[i]:>8.4f}  "
            f"{(mean[i] if i < len(mean) else 0.0):>8.4f}  "
            f"{(rej[i] * 100 if i < len(rej) else 0.0):>5.1f} "
            f"{(hit[i] * 100 if i < len(hit) else 0.0):>5.1f}  |{bar}")
    cache = summary.get("cache", {})
    if cache:
        lines.append(
            f"cache        : group_hit_rate "
            f"{cache.get('group_hit_rate', 0.0):.4f}  "
            f"unique_groups {cache.get('unique_groups', 0)}  "
            f"engine {cache.get('pop_backend', '?')}  "
            f"batch_evals_per_sec "
            f"{cache.get('batch_evals_per_sec', 0.0):.0f}")
    counters = summary.get("metrics", {}).get("counters", {})
    if counters.get("eval.invalid") is not None \
            and counters.get("eval.states"):
        lines.append(
            f"rejection    : {counters['eval.invalid']} of "
            f"{counters['eval.states']} scored states were unschedulable "
            f"({counters['eval.invalid'] / counters['eval.states']:.1%})")
    return "\n".join(lines)
