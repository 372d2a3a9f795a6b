"""AST determinism lint for the port's engine packages (``python -m
repro_torch lint``; the port's copy of ``repro/analysis/lint.py``, its rules
unchanged, its tables read from ``src/repro_torch/lint.toml``).

Everything this repo pins — bit-for-bit engine equivalence, fixed-seed
search trajectories, ``ir1:`` fingerprints, content-addressed store keys
— rests on determinism invariants that, until now, nothing enforced
mechanically.  This linter walks the ASTs of the engine packages
(``src/repro_torch/{core,search,serve,costmodel,ir,hw,obs}`` by default)
and flags
the four ways nondeterminism historically sneaks into systems like this:

``global-random``
    Module-global RNG state (``random.random()``, ``np.random.shuffle``,
    ``from random import randint``): unseeded and shared across callers.
    Constructing *owned* generators (``random.Random(seed)``,
    ``np.random.default_rng(seed)``) is the sanctioned pattern and is not
    flagged.
``wall-clock``
    Wall-time and entropy reads (``time.time``/``time_ns``,
    ``datetime.now``/``utcnow``/``today``, ``os.urandom``,
    ``uuid.uuid1``/``uuid4``) in engine paths.  Monotonic timers
    (``perf_counter``/``monotonic``/``process_time``) are fine — they
    measure, they don't feed results.
``unordered-iter``
    Direct iteration over ``set`` literals, ``set()``/``frozenset()``
    calls, or ``os.listdir()`` in ``for``/comprehensions.  String hashing
    is salted per process and directory order is filesystem-dependent, so
    anything derived from such an iteration (fingerprints, store keys,
    RNG consumption order) varies across runs unless ``sorted()`` wraps
    the iterable.
``mutable-default``
    Mutable default arguments (``def f(x, cache={})``): call-order-
    dependent shared state.
``import-boundary``
    Architectural isolation pins, declared as a ``lint.toml`` table
    mapping a file to the modules it must never import (directly, lazy
    imports included)::

        [tool.repro.lint.boundaries]
        "src/repro_torch/analysis/verify.py" = [
            "repro_torch.core.fusion", "repro_torch.costmodel.evaluator",
            "repro", "jax"]

    The independent checkers (``analysis.verify``, ``analysis.spacemap``)
    must share no code with the engine they check — an engine bug must
    not be able to hide its own evidence — and every linted file of the
    port is pinned against ``repro`` (the reference package) and ``jax``.
    Boundary files are checked on *every* lint run, whatever paths were
    passed; a table row naming a missing file is itself a finding, so the
    table cannot rot.
``clock-seam``
    Instrumented modules must take *every* clock reading — wall or
    monotonic — through :mod:`repro_torch.obs.clock`, the engine's single
    audited time seam, declared as a ``lint.toml`` path list::

        [tool.repro.lint.clock_seam]
        paths = ["src/repro_torch/search/session.py", ...]

    Any direct ``time.*`` / ``datetime.*`` call (or ``from time import
    ...``) in a listed file is a finding — stricter than ``wall-clock``,
    which permits monotonic timers: telemetry timestamps that bypass the
    seam fragment the determinism audit across call sites.  Like the
    boundary table, listed files are checked on every run and a row
    naming a missing file is itself a finding.

Findings are suppressed only through the allowlist in ``lint.toml``:

.. code-block:: toml

    [tool.repro.lint]
    allow = [
        "src/repro/search/artifact.py::wall-clock::time.time::reason...",
    ]

Each entry is ``path::rule::symbol::justification`` — four ``::``-joined
fields, justification mandatory.  Malformed entries are themselves
findings (``bad-allow``), and entries that no longer match any finding
are findings too (``stale-allow``), so the allowlist can neither rot nor
hide unexplained suppressions.  The tables keep the reference's names
(``[tool.repro.lint]``, ``.boundaries``, ``.clock_seam``) and syntax, so the
reference's mini TOML reader (kept for Python 3.10, which has no
``tomllib``) reads them; the port keeps them in its own file because
``pyproject.toml`` holds the reference's.
"""
from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

#: packages linted by default (relative to ``<root>/src/repro_torch``)
DEFAULT_PACKAGES = ("core", "search", "serve", "costmodel", "ir", "hw",
                    "obs")

#: the port's lint tables, relative to the root (the reference keeps its
#: own in ``pyproject.toml``); findings about the tables name this file
CONFIG = "src/repro_torch/lint.toml"

RULES = ("global-random", "wall-clock", "unordered-iter", "mutable-default",
         "import-boundary", "clock-seam")

#: RNG *constructors*: owning a seeded generator is the sanctioned pattern
_RNG_CONSTRUCTORS = {"Random", "SystemRandom", "default_rng", "Generator",
                     "RandomState", "SeedSequence", "PCG64", "Philox",
                     "MT19937", "BitGenerator"}
_WALL_TIME = {"time", "time_ns"}
_WALL_DATETIME = {"now", "utcnow", "today"}
_WALL_UUID = {"uuid1", "uuid4"}


@dataclass(frozen=True)
class Finding:
    """One lint hit.  ``symbol`` is the stable handle allowlist entries
    match on (e.g. ``time.time``, ``os.listdir``, a function name for
    ``mutable-default``)."""

    path: str
    line: int
    rule: str
    symbol: str
    message: str

    def describe(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def to_dict(self) -> Dict[str, object]:
        return {"path": self.path, "line": self.line, "rule": self.rule,
                "symbol": self.symbol, "message": self.message}


@dataclass(frozen=True)
class AllowEntry:
    path: str
    rule: str
    symbol: str
    justification: str
    raw: str

    def matches(self, f: Finding) -> bool:
        return (self.path == f.path and self.rule == f.rule
                and self.symbol == f.symbol)


def parse_allow_entries(raw: Sequence[str]
                        ) -> Tuple[List[AllowEntry], List[Finding]]:
    """Parse raw ``path::rule::symbol::justification`` strings; malformed
    entries (wrong arity, empty field, unknown rule) become ``bad-allow``
    findings instead of silently suppressing nothing."""
    entries: List[AllowEntry] = []
    bad: List[Finding] = []
    for s in raw:
        parts = s.split("::")
        if len(parts) != 4 or not all(p.strip() for p in parts):
            bad.append(Finding(
                CONFIG, 0, "bad-allow", s,
                f"allowlist entry {s!r} is not "
                f"'path::rule::symbol::justification' with every field "
                f"(including the justification) non-empty"))
            continue
        path, rule, symbol, just = (p.strip() for p in parts)
        if rule not in RULES:
            bad.append(Finding(
                CONFIG, 0, "bad-allow", s,
                f"allowlist entry {s!r} names unknown rule {rule!r} "
                f"(rules: {', '.join(RULES)})"))
            continue
        entries.append(AllowEntry(path, rule, symbol, just, s))
    return entries, bad


def load_pyproject_allow(pyproject_path: str) -> List[str]:
    """The raw ``[tool.repro.lint] allow`` list, via a mini TOML reader
    (section + one string array; the floor interpreter has no tomllib)."""
    try:
        with open(pyproject_path) as f:
            text = f.read()
    except FileNotFoundError:
        return []
    sec = re.search(r"(?ms)^\[tool\.repro\.lint\]\s*$(.*?)(?=^\[|\Z)", text)
    if not sec:
        return []
    arr = re.search(r"(?ms)^allow\s*=\s*\[(.*?)\]", sec.group(1))
    if not arr:
        return []
    return [m.group(1) for m in
            re.finditer(r'"((?:[^"\\]|\\.)*)"', arr.group(1))]


def load_pyproject_boundaries(pyproject_path: str) -> Dict[str, List[str]]:
    """The ``[tool.repro.lint.boundaries]`` table — quoted file path ->
    list of module names it must not import — read with the same mini
    TOML reader as the allowlist."""
    try:
        with open(pyproject_path) as f:
            text = f.read()
    except FileNotFoundError:
        return {}
    sec = re.search(
        r"(?ms)^\[tool\.repro\.lint\.boundaries\]\s*$(.*?)(?=^\[|\Z)", text)
    if not sec:
        return {}
    out: Dict[str, List[str]] = {}
    for row in re.finditer(
            r'(?ms)^"((?:[^"\\]|\\.)*)"\s*=\s*\[(.*?)\]', sec.group(1)):
        out[row.group(1)] = [m.group(1) for m in
                             re.finditer(r'"((?:[^"\\]|\\.)*)"',
                                         row.group(2))]
    return out


def load_pyproject_clock_seam(pyproject_path: str) -> List[str]:
    """The ``[tool.repro.lint.clock_seam] paths`` list — files whose every
    clock reading must route through ``repro_torch.obs.clock`` — read with the
    same mini TOML reader as the allowlist."""
    try:
        with open(pyproject_path) as f:
            text = f.read()
    except FileNotFoundError:
        return []
    sec = re.search(
        r"(?ms)^\[tool\.repro\.lint\.clock_seam\]\s*$(.*?)(?=^\[|\Z)", text)
    if not sec:
        return []
    arr = re.search(r"(?ms)^paths\s*=\s*\[(.*?)\]", sec.group(1))
    if not arr:
        return []
    return [m.group(1) for m in
            re.finditer(r'"((?:[^"\\]|\\.)*)"', arr.group(1))]


def check_clock_seam(root: str, seam_paths: Sequence[str]) -> List[Finding]:
    """Enforce the clock-seam table: in a listed file, every ``time.*`` /
    ``datetime.*`` call — monotonic timers included — and every ``from
    time import ...`` binding is a finding; time flows only through
    :mod:`repro_torch.obs.clock`.  Like the boundary table, a row naming a
    missing file is itself a finding."""
    findings: List[Finding] = []
    for rel in sorted(seam_paths):
        full = os.path.join(root, rel)
        shown = rel.replace(os.sep, "/")
        if not os.path.isfile(full):
            findings.append(Finding(
                CONFIG, 0, "clock-seam", rel,
                f"clock_seam table names {rel!r} but no such file exists "
                f"under the root — fix the path or delete the row"))
            continue
        with open(full) as f:
            source = f.read()
        try:
            tree = ast.parse(source, filename=full)
        except SyntaxError as e:
            findings.append(Finding(
                shown, e.lineno or 0, "parse-error", "syntax",
                f"file does not parse: {e.msg}"))
            continue
        # pass 1: names this file binds to the time/datetime modules (or
        # the datetime/date classes); `from time import X` is flagged at
        # the import itself — the binding bypasses the seam however it is
        # later called
        time_mods: Set[str] = set()
        dt_mods: Set[str] = set()
        dt_classes: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    bound = alias.asname or alias.name.split(".", 1)[0]
                    if alias.name == "time":
                        time_mods.add(bound)
                    elif alias.name == "datetime":
                        dt_mods.add(bound)
            elif isinstance(node, ast.ImportFrom) and not node.level:
                if node.module == "time":
                    for alias in node.names:
                        findings.append(Finding(
                            shown, node.lineno, "clock-seam",
                            f"time.{alias.name}",
                            f"'from time import {alias.name}' bypasses "
                            f"the repro_torch.obs.clock seam — call "
                            f"clock.now()/clock.perf_counter()/"
                            f"clock.unix_time() instead"))
                elif node.module == "datetime":
                    for alias in node.names:
                        if alias.name in ("datetime", "date"):
                            dt_classes.add(alias.asname or alias.name)
        # pass 2: every call through those bindings is a seam bypass
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            parts = _dotted(node.func)
            if not parts:
                continue
            head, last = parts[0], parts[-1]
            if head in time_mods and len(parts) == 2:
                findings.append(Finding(
                    shown, node.lineno, "clock-seam", f"time.{last}",
                    f"{'.'.join(parts)}() bypasses the repro_torch.obs.clock "
                    f"seam (monotonic timers included — telemetry "
                    f"timestamps must share one audited source)"))
            elif (head in dt_classes and len(parts) == 2) or \
                    (head in dt_mods and len(parts) == 3
                     and parts[1] in ("datetime", "date")):
                findings.append(Finding(
                    shown, node.lineno, "clock-seam", f"datetime.{last}",
                    f"{'.'.join(parts)}() bypasses the repro_torch.obs.clock "
                    f"seam — route wall-time reads through clock.*"))
    return findings


def check_boundaries(root: str, boundaries: Dict[str, Sequence[str]]
                     ) -> List[Finding]:
    """Enforce the import-boundary table: every ``Import``/``ImportFrom``
    in a listed file (top-level or lazy) is matched against that file's
    forbidden module prefixes.  ``from repro_torch.core import fusion`` counts
    as importing ``repro_torch.core.fusion``; relative imports are out of scope
    (the pinned modules live in other packages)."""
    findings: List[Finding] = []
    for rel in sorted(boundaries):
        full = os.path.join(root, rel)
        shown = rel.replace(os.sep, "/")
        forbidden = tuple(boundaries[rel])
        if not os.path.isfile(full):
            findings.append(Finding(
                CONFIG, 0, "import-boundary", rel,
                f"boundary table names {rel!r} but no such file exists "
                f"under the root — fix the path or delete the row"))
            continue
        with open(full) as f:
            source = f.read()
        try:
            tree = ast.parse(source, filename=full)
        except SyntaxError as e:
            findings.append(Finding(
                shown, e.lineno or 0, "parse-error", "syntax",
                f"file does not parse: {e.msg}"))
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and not node.level:
                mods = [node.module] + [f"{node.module}.{a.name}"
                                        for a in node.names]
            else:
                continue
            for mod in mods:
                hit = next((fb for fb in forbidden
                            if mod == fb or mod.startswith(fb + ".")), None)
                if hit is not None:
                    findings.append(Finding(
                        shown, getattr(node, "lineno", 0),
                        "import-boundary", hit,
                        f"imports {mod}, but the boundary table pins this "
                        f"file against {hit}: the independent checker "
                        f"must share no code with the engine it checks"))
                    break                    # one finding per import stmt
    return findings


def _dotted(node: ast.AST) -> Optional[List[str]]:
    """``a.b.c`` attribute chain as ``["a", "b", "c"]`` (None when the
    base is an expression, e.g. ``get_rng().random``)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return None


class _FileLinter(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.findings: List[Finding] = []
        # local names bound to each watched module / class
        self.random_mods: Set[str] = set()     # `random`
        self.numpy_mods: Set[str] = set()      # `numpy`
        self.np_random_mods: Set[str] = set()  # `numpy.random` aliases
        self.time_mods: Set[str] = set()
        self.os_mods: Set[str] = set()
        self.uuid_mods: Set[str] = set()
        self.datetime_mods: Set[str] = set()   # the `datetime` module
        self.datetime_classes: Set[str] = set()  # `datetime`/`date` classes

    def _hit(self, node: ast.AST, rule: str, symbol: str,
             message: str) -> None:
        self.findings.append(Finding(
            self.path, getattr(node, "lineno", 0), rule, symbol, message))

    # ---- imports ----------------------------------------------------------------
    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            bound = alias.asname or alias.name.split(".", 1)[0]
            if alias.name == "random":
                self.random_mods.add(bound)
            elif alias.name == "numpy":
                self.numpy_mods.add(bound)
            elif alias.name == "numpy.random":
                if alias.asname:
                    self.np_random_mods.add(alias.asname)
                else:
                    self.numpy_mods.add("numpy")
            elif alias.name == "time":
                self.time_mods.add(bound)
            elif alias.name == "os":
                self.os_mods.add(bound)
            elif alias.name == "uuid":
                self.uuid_mods.add(bound)
            elif alias.name == "datetime":
                self.datetime_mods.add(bound)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        mod = node.module or ""
        for alias in node.names:
            name = alias.name
            if mod == "random" and name not in _RNG_CONSTRUCTORS:
                self._hit(node, "global-random", f"random.{name}",
                          f"'from random import {name}' binds module-"
                          f"global RNG state; own a random.Random(seed)")
            elif mod == "numpy.random" and name not in _RNG_CONSTRUCTORS:
                self._hit(node, "global-random", f"numpy.random.{name}",
                          f"'from numpy.random import {name}' binds "
                          f"global RNG state; own a default_rng(seed)")
            elif mod == "time" and name in _WALL_TIME:
                self._hit(node, "wall-clock", f"time.{name}",
                          f"'from time import {name}' pulls wall-clock "
                          f"into an engine path")
            elif mod == "os" and name == "urandom":
                self._hit(node, "wall-clock", "os.urandom",
                          "'from os import urandom' pulls entropy into "
                          "an engine path")
            elif mod == "uuid" and name in _WALL_UUID:
                self._hit(node, "wall-clock", f"uuid.{name}",
                          f"'from uuid import {name}' is time/entropy-"
                          f"derived")
            elif mod == "datetime" and name in ("datetime", "date"):
                self.datetime_classes.add(alias.asname or name)

    # ---- calls ------------------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        parts = _dotted(node.func)
        if parts:
            self._check_call(node, parts)
        self.generic_visit(node)

    def _check_call(self, node: ast.Call, parts: List[str]) -> None:
        head, last = parts[0], parts[-1]
        if head in self.random_mods and len(parts) == 2 \
                and last not in _RNG_CONSTRUCTORS:
            self._hit(node, "global-random", f"random.{last}",
                      f"{'.'.join(parts)}() uses the module-global RNG; "
                      f"thread an owned random.Random(seed) instead")
        elif ((head in self.numpy_mods and len(parts) == 3
               and parts[1] == "random")
              or (head in self.np_random_mods and len(parts) == 2)) \
                and last not in _RNG_CONSTRUCTORS:
            self._hit(node, "global-random", f"numpy.random.{last}",
                      f"{'.'.join(parts)}() uses numpy's global RNG; "
                      f"thread an owned np.random.default_rng(seed)")
        elif head in self.time_mods and len(parts) == 2 \
                and last in _WALL_TIME:
            self._hit(node, "wall-clock", f"time.{last}",
                      f"{'.'.join(parts)}() reads the wall clock in an "
                      f"engine path (perf_counter/monotonic measure "
                      f"without feeding results)")
        elif head in self.os_mods and len(parts) == 2 \
                and last == "urandom":
            self._hit(node, "wall-clock", "os.urandom",
                      f"{'.'.join(parts)}() reads OS entropy in an "
                      f"engine path")
        elif head in self.uuid_mods and len(parts) == 2 \
                and last in _WALL_UUID:
            self._hit(node, "wall-clock", f"uuid.{last}",
                      f"{'.'.join(parts)}() is time/entropy-derived")
        elif last in _WALL_DATETIME and (
                (head in self.datetime_classes and len(parts) == 2)
                or (head in self.datetime_mods and len(parts) == 3
                    and parts[1] in ("datetime", "date"))):
            self._hit(node, "wall-clock", f"datetime.{last}",
                      f"{'.'.join(parts)}() reads the wall clock in an "
                      f"engine path")

    # ---- unordered iteration ----------------------------------------------------
    def _unordered_source(self, expr: ast.AST) -> Optional[str]:
        if isinstance(expr, ast.Set):
            return "set-literal"
        if isinstance(expr, ast.Call):
            parts = _dotted(expr.func)
            if parts == ["set"] or parts == ["frozenset"]:
                return f"{parts[0]}()"
            if parts and len(parts) == 2 and parts[0] in self.os_mods \
                    and parts[1] == "listdir":
                return "os.listdir"
            if parts == ["listdir"]:
                return "os.listdir"
        return None

    def _check_iter(self, node: ast.AST, iter_expr: ast.AST) -> None:
        src = self._unordered_source(iter_expr)
        if src is not None:
            self._hit(node, "unordered-iter", src,
                      f"iteration order of {src} is not deterministic "
                      f"across processes; wrap it in sorted() before "
                      f"anything order-sensitive consumes it")

    def visit_For(self, node: ast.For) -> None:
        self._check_iter(node, node.iter)
        self.generic_visit(node)

    def _visit_comp(self, node: ast.expr) -> None:
        for gen in node.generators:      # type: ignore[attr-defined]
            self._check_iter(node, gen.iter)
        self.generic_visit(node)

    visit_ListComp = _visit_comp
    visit_SetComp = _visit_comp
    visit_DictComp = _visit_comp
    visit_GeneratorExp = _visit_comp

    # ---- mutable defaults -------------------------------------------------------
    def _visit_func(self, node: ast.FunctionDef) -> None:
        defaults = list(node.args.defaults) \
            + [d for d in node.args.kw_defaults if d is not None]
        for d in defaults:
            bad = isinstance(d, (ast.List, ast.Dict, ast.Set))
            if isinstance(d, ast.Call):
                parts = _dotted(d.func)
                bad = parts in (["list"], ["dict"], ["set"])
            if bad:
                self._hit(d, "mutable-default", node.name,
                          f"def {node.name}(...) has a mutable default "
                          f"argument — shared, call-order-dependent "
                          f"state; default to None")
        self.generic_visit(node)

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func


def lint_file(path: str, display_path: Optional[str] = None
              ) -> List[Finding]:
    """Lint one Python source file; syntax errors are findings, not
    crashes (a file the linter cannot parse is a file it cannot vouch
    for)."""
    shown = display_path or path
    with open(path) as f:
        source = f.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(shown, e.lineno or 0, "parse-error", "syntax",
                        f"file does not parse: {e.msg}")]
    linter = _FileLinter(shown)
    linter.visit(tree)
    return linter.findings


def _default_paths(root: str) -> List[str]:
    return [os.path.join(root, "src", "repro_torch", pkg)
            for pkg in DEFAULT_PACKAGES]


def run_lint(root: str = ".", paths: Optional[Sequence[str]] = None,
             allow_raw: Optional[Sequence[str]] = None,
             boundaries: Optional[Dict[str, Sequence[str]]] = None,
             clock_seam: Optional[Sequence[str]] = None
             ) -> List[Finding]:
    """Lint ``paths`` (default: the engine packages under ``root``),
    enforce the import-boundary and clock-seam tables (defaults: the
    ``[tool.repro.lint.boundaries]`` / ``[tool.repro.lint.clock_seam]``
    tables of ``lint.toml`` — checked on *every* run, whatever ``paths`` say), apply the
    allowlist (default: ``<root>/src/repro_torch/lint.toml``), and return
    surviving
    findings — including ``bad-allow``/``stale-allow`` rows for a
    defective allowlist — sorted by location."""
    pyproject = os.path.join(root, CONFIG)
    if allow_raw is None:
        allow_raw = load_pyproject_allow(pyproject)
    if boundaries is None:
        boundaries = load_pyproject_boundaries(pyproject)
    if clock_seam is None:
        clock_seam = load_pyproject_clock_seam(pyproject)
    entries, findings = parse_allow_entries(allow_raw)

    files: List[Tuple[str, str]] = []
    for p in (paths if paths is not None else _default_paths(root)):
        if os.path.isfile(p):
            files.append((p, os.path.relpath(p, root)))
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames.sort()
            for name in sorted(filenames):
                if name.endswith(".py"):
                    full = os.path.join(dirpath, name)
                    files.append((full, os.path.relpath(full, root)))

    raw_findings: List[Finding] = []
    for full, rel in files:
        raw_findings.extend(lint_file(full, rel.replace(os.sep, "/")))
    raw_findings.extend(check_boundaries(root, boundaries))
    raw_findings.extend(check_clock_seam(root, clock_seam))

    used: Set[str] = set()
    for f in raw_findings:
        matched = [e for e in entries if e.matches(f)]
        if matched:
            used.add(matched[0].raw)
        else:
            findings.append(f)
    for e in entries:
        if e.raw not in used:
            findings.append(Finding(
                CONFIG, 0, "stale-allow", e.raw,
                f"allowlist entry {e.raw!r} matches no finding — the "
                f"code it excused moved or was fixed; delete the entry"))
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule,
                                           f.symbol))
