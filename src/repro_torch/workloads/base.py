"""The parametric ``Workload`` protocol: what the workload registry holds.

A workload is no longer a bare ``(**kwargs) -> LayerGraph`` callable but
an object that *describes itself*: a typed parameter schema plus a
``build``.  That is what lets spec strings (``mobilenet_v3@hw=160``),
``repro list --json`` tooling, and helpful error messages exist without
each caller re-deriving a builder's signature.

    class MyWorkload(Workload):
        name = "my_cnn"
        def params(self): return {"hw": Param("hw", 224, "int")}
        def build(self, **kw): ...

Plain functions still register directly — :class:`FunctionWorkload`
derives the schema from the signature (defaults give the types), so the
zoo builders and third-party ``@register_workload`` functions need no
boilerplate.  :class:`GraphIRWorkload` adapts a fixed
:class:`repro_torch.ir.GraphIR` document (the ``file:model.json`` spec form).
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from repro_torch.core.graph import LayerGraph

_KINDS: Dict[type, str] = {int: "int", float: "float", bool: "bool",
                           str: "str"}
#: annotation spellings under PEP 563 (`from __future__ import
#: annotations` turns every annotation into its source string)
_KIND_NAMES = {"int": "int", "float": "float", "bool": "bool", "str": "str"}
_PARSERS: Dict[str, Callable[[str], Any]] = {
    "int": int, "float": float, "str": str,
    "bool": lambda s: {"true": True, "1": True, "yes": True,
                       "false": False, "0": False, "no": False}[s.lower()],
}


class WorkloadParamError(ValueError):
    """Unknown or untypeable workload parameter; the message carries the
    schema so the caller can self-correct."""


@dataclass(frozen=True)
class Param:
    """One workload parameter: name, default (None = required), and a
    coercion kind (``int`` / ``float`` / ``bool`` / ``str`` / ``any``)."""

    name: str
    default: Any = None
    kind: str = "any"
    required: bool = False

    def coerce(self, value: Any) -> Any:
        """Parse a spec-string value (``"160"`` -> 160) per the schema;
        already-typed values (JSON kwargs) pass through."""
        if not isinstance(value, str) or self.kind in ("str", "any"):
            return value
        try:
            return _PARSERS[self.kind](value)
        except (ValueError, KeyError):
            raise WorkloadParamError(
                f"cannot parse {value!r} as {self.kind} for param "
                f"{self.name!r}") from None

    def describe(self) -> str:
        return f"{self.name}={self.default!r} ({self.kind})" \
            if not self.required else f"{self.name}=<required> ({self.kind})"

    def to_dict(self) -> Dict[str, Any]:
        return {"default": self.default, "type": self.kind,
                "required": self.required}


class Workload:
    """Base protocol: subclasses set :attr:`name` and implement
    :meth:`params` / :meth:`_build`; :meth:`build` layers schema
    validation + value coercion on top."""

    name: str = "workload"

    def params(self) -> Dict[str, Param]:
        return {}

    def doc(self) -> str:
        return (inspect.getdoc(self) or "").split("\n")[0]

    def _build(self, **kwargs) -> LayerGraph:
        raise NotImplementedError

    # ---- public surface --------------------------------------------------------
    #: True when the builder also accepts params beyond the schema
    #: (a ``**kwargs`` signature); unknown names then pass through uncoerced
    open_schema: bool = False

    def build(self, **kwargs) -> LayerGraph:
        """Validate/coerce ``kwargs`` against the schema, then build."""
        schema = self.params()
        unknown = sorted(set(kwargs) - set(schema))
        if unknown and not self.open_schema:
            raise WorkloadParamError(
                f"unknown param(s) {unknown} for workload {self.name!r}; "
                f"{self.schema_hint()}")
        coerced = {k: schema[k].coerce(v) if k in schema else v
                   for k, v in kwargs.items()}
        missing = sorted(p.name for p in schema.values()
                         if p.required and p.name not in coerced)
        if missing:
            raise WorkloadParamError(
                f"workload {self.name!r} requires param(s) {missing}; "
                f"{self.schema_hint()}")
        return self._build(**coerced)

    def schema_hint(self) -> str:
        """One line a user can act on — the schema plus a copy-pasteable
        spec string (mirrors the exhaustive backend's ``limit=`` hint)."""
        schema = self.params()
        if not schema:
            return (f"workload {self.name!r} accepts arbitrary params "
                    f"(**kwargs builder)" if self.open_schema
                    else f"workload {self.name!r} takes no params")
        listing = ", ".join(p.describe() for p in schema.values())
        first = next(iter(schema.values()))
        ex_val = first.default if first.default is not None else 1
        return (f"schema: {listing}; e.g. --workload "
                f"'{self.name}@{first.name}={ex_val}' or "
                f"workload_kwargs={{\"{first.name}\": {ex_val!r}}}")

    def describe(self) -> Dict[str, Any]:
        """Machine-readable description (``repro list --json``)."""
        d = {"doc": self.doc(),
             "params": {k: p.to_dict() for k, p in self.params().items()}}
        if self.open_schema:
            d["open_schema"] = True
        return d


class FunctionWorkload(Workload):
    """A plain ``(**kwargs) -> LayerGraph`` builder, schema derived from
    its signature (annotation first, else the default's type)."""

    def __init__(self, name: str, fn: Callable[..., LayerGraph]):
        self.name = name
        self.fn = fn
        self._params: Dict[str, Param] = {}
        try:
            sig = inspect.signature(fn)
        except (TypeError, ValueError):
            sig = None
        if sig is None:
            self.open_schema = True      # unintrospectable: don't reject
        for pname, p in (sig.parameters.items() if sig else ()):
            if p.kind is inspect.Parameter.VAR_KEYWORD:
                self.open_schema = True  # **kwargs: extra params allowed
                continue
            if p.kind is inspect.Parameter.VAR_POSITIONAL:
                continue
            default = None if p.default is inspect.Parameter.empty \
                else p.default
            # PEP 563 (`from __future__ import annotations`) leaves the
            # annotation as the string "int" — resolve both spellings
            ann = p.annotation
            kind = _KINDS.get(ann) if isinstance(ann, type) else \
                _KIND_NAMES.get(ann.strip()) if isinstance(ann, str) \
                else None
            kind = kind or _KINDS.get(type(default), "any")
            self._params[pname] = Param(
                pname, default, kind,
                required=p.default is inspect.Parameter.empty)

    def params(self) -> Dict[str, Param]:
        return dict(self._params)

    def doc(self) -> str:
        return (inspect.getdoc(self.fn) or "").split("\n")[0]

    def _build(self, **kwargs) -> LayerGraph:
        return self.fn(**kwargs)


class GraphIRWorkload(Workload):
    """A fixed :class:`repro_torch.ir.GraphIR` document (``file:`` specs and
    embedded-IR artifacts); parameterless by construction."""

    def __init__(self, ir, name: Optional[str] = None):
        self.ir = ir
        self.name = name or ir.name

    def doc(self) -> str:
        return f"GraphIR document ({len(self.ir.nodes)} nodes)"

    def _build(self, **kwargs) -> LayerGraph:
        return self.ir.build()


def as_workload(obj: Any, name: str) -> Workload:
    """Adapt a registry entry to the protocol: Workload instances pass
    through, Workload subclasses are instantiated, callables are wrapped."""
    if isinstance(obj, Workload):
        return obj
    if isinstance(obj, type) and issubclass(obj, Workload):
        return obj()
    if callable(obj):
        return FunctionWorkload(name, obj)
    raise TypeError(f"workload {name!r} is neither a Workload nor a "
                    f"callable: {type(obj).__name__}")
