"""Declarative search specification: everything needed to (re)run a search.

A :class:`SearchSpec` is the unit a scheduler service accepts and an
artifact embeds: registry names (not live objects) plus backend config,
seed, and budget, so it JSON-round-trips and two specs can be diffed
field-by-field.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass(frozen=True)
class SearchSpec:
    """What to search: (workload, accelerator, objective) — and how:
    (backend + config, seed, budget).

    ``workload``/``accelerator``/``objective``/``backend``/``costmodel``
    are registry names (``repro_torch.search.registry``); ``workload`` accepts
    every spec form — ``name``, ``name@key=value,...`` (params coerced
    against the workload's schema), ``file:model.json`` (a
    ``repro_torch.ir`` GraphIR document), or ``ir:<fingerprint>`` (IR embedded
    in the producing artifact); ``accelerator`` may
    carry a repartition suffix (``eyeriss@act+64``); ``costmodel`` picks
    the cost backend scoring the schedules (``default`` = the paper's
    mini-Timeloop mapper, ``tpu`` = the TPU roofline).  ``budget`` stops
    the search at the end of the first backend step (generation/chunk)
    that reaches this many offspring evaluations — the cap can overshoot
    by up to one step's worth (None = backend default); ``patience``
    stops after that many steps without improvement (None = run the full
    budget).
    """

    workload: str
    accelerator: str = "simba"
    objective: str = "edp"
    backend: str = "ga"
    costmodel: str = "default"
    backend_config: Dict[str, Any] = field(default_factory=dict)
    workload_kwargs: Dict[str, Any] = field(default_factory=dict)
    seed: int = 0
    budget: Optional[int] = None
    patience: Optional[int] = None
    #: opt into the static fusion-space analysis
    #: (:mod:`repro_torch.analysis.spacemap`): provably forced-off genes are
    #: frozen out of the genome and the exhaustive backend enumerates per
    #: independent region.  Fixed-seed trajectories differ from
    #: ``spacemap=False`` runs (fewer RNG draws), hence opt-in.
    spacemap: bool = False
    #: opt into search telemetry (:mod:`repro_torch.obs`): per-generation
    #: convergence records and an embedded artifact ``telemetry`` summary;
    #: span events additionally stream to a JSONL file when ``--trace`` /
    #: ``REPRO_TRACE`` names one.  Unlike ``spacemap`` this never changes
    #: the search itself: winner mask, fitness, RNG draw sequence, and
    #: store keys are bit-identical to ``telemetry=False`` (pinned by
    #: ``tests/test_obs_search.py``).
    telemetry: bool = False

    def __post_init__(self):
        # freeze the nested dicts against aliasing surprises: specs are
        # copied into artifacts and compared across sessions
        object.__setattr__(self, "backend_config",
                           dict(self.backend_config))
        object.__setattr__(self, "workload_kwargs",
                           dict(self.workload_kwargs))

    # ---- serialization --------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        for flag in ("spacemap", "telemetry"):
            if not d[flag]:
                # default-off fields serialize only when set: the canonical
                # spec JSON (and therefore every existing store content
                # address, which hashes it) is unchanged for specs written
                # by any earlier build
                del d[flag]
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SearchSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown SearchSpec fields: {sorted(unknown)}")
        return cls(**d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "SearchSpec":
        return cls.from_dict(json.loads(text))

    def replace(self, **changes) -> "SearchSpec":
        return dataclasses.replace(self, **changes)
