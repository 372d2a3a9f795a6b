"""The port's determinism lint (``repro_torch.analysis.lint``) on the CPU,
against the reference's.

The first part is ``tests/test_analysis_lint.py`` with the port's module:
rule detection on synthetic modules, allowlist semantics (match / stale /
malformed), the mini TOML reader, and the gate — ``src/repro_torch`` is
clean under the port's tables, which live in ``src/repro_torch/lint.toml``
(findings about the tables name that file, where the reference's name
``pyproject.toml``).  The second part runs both packages' lints on the same
fixture sources and table files and compares their findings, and checks
that every linted port file is pinned against ``repro`` and ``jax``.
"""
import textwrap

from repro_torch.analysis.lint import (CONFIG, RULES, check_boundaries,
                                       check_clock_seam, lint_file,
                                       load_pyproject_allow,
                                       load_pyproject_boundaries,
                                       load_pyproject_clock_seam,
                                       parse_allow_entries, run_lint)


def _lint(tmp_path, source, name="mod.py"):
    p = tmp_path / name
    p.write_text(textwrap.dedent(source))
    return lint_file(str(p), name)


def _rules(findings):
    return sorted((f.rule, f.symbol) for f in findings)


# ---- global-random ---------------------------------------------------------------


def test_global_random_module_calls_flagged(tmp_path):
    found = _lint(tmp_path, """\
        import random
        import numpy as np
        random.seed(0)
        x = random.randint(0, 7)
        y = np.random.rand(3)
    """)
    assert ("global-random", "random.seed") in _rules(found)
    assert ("global-random", "random.randint") in _rules(found)
    assert ("global-random", "numpy.random.rand") in _rules(found)


def test_seeded_constructors_are_not_flagged(tmp_path):
    found = _lint(tmp_path, """\
        import random
        import numpy as np
        rng = random.Random(0)
        g = np.random.default_rng(0)
        legacy = np.random.RandomState(0)
        x = rng.randint(0, 7) + g.integers(0, 7)
    """)
    assert found == []


def test_from_import_of_random_function_flagged(tmp_path):
    found = _lint(tmp_path, "from random import randint\n")
    assert _rules(found) == [("global-random", "random.randint")]


# ---- wall-clock ------------------------------------------------------------------


def test_wall_clock_sources_flagged(tmp_path):
    found = _lint(tmp_path, """\
        import os
        import time
        import uuid
        from datetime import datetime
        a = time.time()
        b = time.time_ns()
        c = datetime.now()
        d = os.urandom(16)
        e = uuid.uuid4()
    """)
    rules = _rules(found)
    for sym in ("time.time", "time.time_ns", "datetime.now", "os.urandom",
                "uuid.uuid4"):
        assert ("wall-clock", sym) in rules


def test_monotonic_clocks_are_fine(tmp_path):
    found = _lint(tmp_path, """\
        import time
        t0 = time.perf_counter()
        t1 = time.monotonic()
    """)
    assert found == []


# ---- unordered-iter --------------------------------------------------------------


def test_iteration_over_set_flagged(tmp_path):
    found = _lint(tmp_path, """\
        import os
        for x in {1, 2, 3}:
            pass
        ys = [y for y in set(range(4))]
        zs = list(os.listdir("."))
        for z in os.listdir("."):
            pass
    """)
    rules = [f.rule for f in found]
    assert rules.count("unordered-iter") == 3  # zs=list(...) is not iter'd


def test_sorted_wrapper_is_fine(tmp_path):
    found = _lint(tmp_path, """\
        import os
        for x in sorted({3, 1, 2}):
            pass
        for p in sorted(os.listdir(".")):
            pass
    """)
    assert found == []


# ---- mutable-default -------------------------------------------------------------


def test_mutable_defaults_flagged(tmp_path):
    found = _lint(tmp_path, """\
        def f(xs=[]):
            return xs
        def g(*, opts={}):
            return opts
        def h(s=set()):
            return s
        def ok(xs=None, n=3, t=()):
            return xs
    """)
    assert [f.symbol for f in found
            if f.rule == "mutable-default"] == ["f", "g", "h"]


# ---- parse errors are loud and unallowlistable -----------------------------------


def test_syntax_error_reported_not_swallowed(tmp_path):
    found = _lint(tmp_path, "def broken(:\n")
    assert len(found) == 1
    assert found[0].rule == "parse-error"
    assert "parse-error" not in RULES  # cannot be allowlisted


# ---- allowlist semantics ---------------------------------------------------------


def test_allow_entry_suppresses_exact_match(tmp_path):
    (tmp_path / "src" / "repro_torch" / "core").mkdir(parents=True)
    mod = tmp_path / "src" / "repro_torch" / "core" / "clocky.py"
    mod.write_text("import time\nT = time.time()\n")
    allow = ["src/repro_torch/core/clocky.py::wall-clock::time.time::"
             "test fixture; value is discarded"]
    findings = run_lint(str(tmp_path), allow_raw=allow)
    assert findings == []


def test_unused_allow_entry_is_stale(tmp_path):
    (tmp_path / "src" / "repro_torch" / "core").mkdir(parents=True)
    (tmp_path / "src" / "repro_torch" / "core" / "clean.py").write_text("x = 1\n")
    findings = run_lint(str(tmp_path), allow_raw=[
        "src/repro_torch/core/gone.py::wall-clock::time.time::was needed once"])
    assert [f.rule for f in findings] == ["stale-allow"]
    assert "gone.py" in findings[0].message


def test_malformed_allow_entries_are_bad(tmp_path):
    (tmp_path / "src" / "repro_torch" / "core").mkdir(parents=True)
    (tmp_path / "src" / "repro_torch" / "core" / "clean.py").write_text("x = 1\n")
    findings = run_lint(str(tmp_path), allow_raw=[
        "only::three::fields",                          # wrong arity
        "a.py::wall-clock::time.time::",                # empty justification
        "a.py::no-such-rule::x::because",               # unknown rule
    ])
    assert [f.rule for f in findings] == ["bad-allow"] * 3


def test_parse_allow_entries_roundtrip():
    entries, bad = parse_allow_entries(
        ["src/a.py::wall-clock::time.time::logging timestamps only"])
    assert bad == []
    (e,) = entries
    assert (e.path, e.rule, e.symbol) == ("src/a.py", "wall-clock",
                                          "time.time")
    assert e.justification.startswith("logging")


# ---- pyproject mini-parser -------------------------------------------------------


def test_load_pyproject_allow_reads_section(tmp_path):
    pj = tmp_path / "pyproject.toml"
    pj.write_text(textwrap.dedent("""\
        [tool.other]
        allow = ["decoy"]

        [tool.repro.lint]
        # comment line
        allow = [
            "src/a.py::wall-clock::time.time::why not",
            "src/b.py::global-random::random.seed::legacy",
        ]

        [tool.after]
        x = 1
    """))
    assert load_pyproject_allow(str(pj)) == [
        "src/a.py::wall-clock::time.time::why not",
        "src/b.py::global-random::random.seed::legacy",
    ]


def test_load_pyproject_allow_missing_section(tmp_path):
    pj = tmp_path / "pyproject.toml"
    pj.write_text("[project]\nname = 'x'\n")
    assert load_pyproject_allow(str(pj)) == []


# ---- import-boundary -------------------------------------------------------------


def test_boundary_violations_flagged_top_level_and_lazy(tmp_path):
    mod = tmp_path / "checker.py"
    mod.write_text(textwrap.dedent("""\
        import repro.core.fusion
        from repro.costmodel import something_else

        def lazy():
            from repro.costmodel.evaluator import Evaluator
            return Evaluator
    """))
    found = check_boundaries(str(tmp_path), {
        "checker.py": ["repro.core.fusion", "repro.costmodel.evaluator"]})
    assert _rules(found) == [
        ("import-boundary", "repro.core.fusion"),
        ("import-boundary", "repro.costmodel.evaluator"),  # lazy counts
    ]
    assert all(f.path == "checker.py" for f in found)


def test_boundary_matches_from_import_of_pinned_module(tmp_path):
    # `from repro.core import fusion` imports repro.core.fusion just the
    # same; `import repro.core.graph` must NOT match the fusion pin
    mod = tmp_path / "checker.py"
    mod.write_text("from repro.core import fusion\n"
                   "import repro.core.graph\n")
    found = check_boundaries(str(tmp_path),
                             {"checker.py": ["repro.core.fusion"]})
    assert _rules(found) == [("import-boundary", "repro.core.fusion")]


def test_clean_file_produces_no_boundary_findings(tmp_path):
    (tmp_path / "checker.py").write_text(
        "import repro.core.graph\nfrom repro.analysis import bounds\n")
    assert check_boundaries(str(tmp_path), {
        "checker.py": ["repro.core.fusion",
                       "repro.costmodel.evaluator"]}) == []


def test_boundary_row_naming_missing_file_is_a_finding(tmp_path):
    found = check_boundaries(str(tmp_path),
                             {"gone/nowhere.py": ["repro.core.fusion"]})
    assert [f.rule for f in found] == ["import-boundary"]
    assert found[0].path == CONFIG
    assert "no such file" in found[0].message


def test_boundaries_checked_on_every_run_regardless_of_paths(tmp_path):
    (tmp_path / "checker.py").write_text("import repro.core.fusion\n")
    findings = run_lint(str(tmp_path), paths=[],   # lint NO files...
                        allow_raw=[],
                        boundaries={"checker.py": ["repro.core.fusion"]})
    assert _rules(findings) == [  # ...the boundary table still fires
        ("import-boundary", "repro.core.fusion")]


def test_allow_entry_can_suppress_a_boundary_finding(tmp_path):
    (tmp_path / "checker.py").write_text("import repro.core.fusion\n")
    findings = run_lint(
        str(tmp_path), paths=[],
        allow_raw=["checker.py::import-boundary::repro.core.fusion::"
                   "transitional shim while the checker is split out"],
        boundaries={"checker.py": ["repro.core.fusion"]})
    assert findings == []


def test_load_pyproject_boundaries_reads_table(tmp_path):
    pj = tmp_path / "pyproject.toml"
    pj.write_text(textwrap.dedent("""\
        [tool.repro.lint]
        allow = []

        [tool.repro.lint.boundaries]
        # the checkers must not lean on the engine
        "src/a.py" = ["repro.core.fusion", "repro.costmodel.evaluator"]
        "src/b.py" = [
            "repro.core.fusion",
        ]

        [tool.after]
        x = 1
    """))
    assert load_pyproject_boundaries(str(pj)) == {
        "src/a.py": ["repro.core.fusion", "repro.costmodel.evaluator"],
        "src/b.py": ["repro.core.fusion"],
    }


def test_load_pyproject_boundaries_missing_section(tmp_path):
    pj = tmp_path / "pyproject.toml"
    pj.write_text("[project]\nname = 'x'\n")
    assert load_pyproject_boundaries(str(pj)) == {}
    assert load_pyproject_boundaries(str(tmp_path / "absent.toml")) == {}


def test_repo_boundary_table_pins_both_checkers():
    table = load_pyproject_boundaries(CONFIG)
    for rel in ("src/repro_torch/analysis/verify.py",
                "src/repro_torch/analysis/spacemap.py"):
        assert set(table[rel]) == {"repro_torch.core.fusion",
                                   "repro_torch.costmodel.evaluator",
                                   "repro", "jax"}, rel


# ---- the CI gate: the engine itself is clean -------------------------------------


def test_engine_packages_are_lint_clean_under_repo_allowlist():
    findings = run_lint(".")
    assert findings == [], "\n".join(f.describe() for f in findings)


def test_repo_allowlist_has_no_unexplained_suppressions():
    raw = load_pyproject_allow(CONFIG)
    entries, bad = parse_allow_entries(raw)
    assert bad == []
    for e in entries:
        # a real justification, not a placeholder
        assert len(e.justification.split()) >= 4, e.raw


# ---- clock-seam ------------------------------------------------------------------


def test_clock_seam_flags_all_time_calls_including_monotonic(tmp_path):
    (tmp_path / "inst.py").write_text(textwrap.dedent("""\
        import time
        import datetime
        t0 = time.perf_counter()
        now = time.time()
        stamp = datetime.datetime.now()
    """))
    found = check_clock_seam(str(tmp_path), ["inst.py"])
    assert _rules(found) == [("clock-seam", "datetime.now"),
                             ("clock-seam", "time.perf_counter"),
                             ("clock-seam", "time.time")]


def test_clock_seam_flags_from_time_import_at_the_import(tmp_path):
    (tmp_path / "inst.py").write_text(
        "from time import perf_counter\nx = perf_counter()\n")
    found = check_clock_seam(str(tmp_path), ["inst.py"])
    assert _rules(found) == [("clock-seam", "time.perf_counter")]


def test_clock_seam_clean_file_routing_through_the_seam(tmp_path):
    (tmp_path / "inst.py").write_text(textwrap.dedent("""\
        from repro.obs import clock
        t0 = clock.perf_counter()
        created = clock.unix_time()
    """))
    assert check_clock_seam(str(tmp_path), ["inst.py"]) == []


def test_clock_seam_row_naming_missing_file_is_a_finding(tmp_path):
    found = check_clock_seam(str(tmp_path), ["gone/nowhere.py"])
    assert [f.rule for f in found] == ["clock-seam"]
    assert found[0].path == CONFIG
    assert "no such file" in found[0].message


def test_clock_seam_checked_on_every_run_and_allowlistable(tmp_path):
    (tmp_path / "inst.py").write_text("import time\nt = time.time()\n")
    findings = run_lint(str(tmp_path), paths=[], allow_raw=[],
                        boundaries={}, clock_seam=["inst.py"])
    assert ("clock-seam", "time.time") in _rules(findings)
    findings = run_lint(
        str(tmp_path), paths=[],
        allow_raw=["inst.py::clock-seam::time.time::"
                   "transitional direct read while the seam lands"],
        boundaries={}, clock_seam=["inst.py"])
    assert findings == []


def test_load_pyproject_clock_seam_reads_paths(tmp_path):
    pj = tmp_path / "pyproject.toml"
    pj.write_text(textwrap.dedent("""\
        [tool.repro.lint]
        allow = []

        [tool.repro.lint.clock_seam]
        # time flows through repro.obs.clock only
        paths = [
            "src/a.py",
            "src/b.py",
        ]

        [tool.after]
        x = 1
    """))
    assert load_pyproject_clock_seam(str(pj)) == ["src/a.py", "src/b.py"]
    assert load_pyproject_clock_seam(str(tmp_path / "absent.toml")) == []


def test_repo_clock_seam_table_pins_the_instrumented_modules():
    paths = load_pyproject_clock_seam(CONFIG)
    for rel in ("src/repro_torch/search/session.py",
                "src/repro_torch/costmodel/evaluator.py",
                "src/repro_torch/core/population.py",
                "src/repro_torch/search/artifact.py"):
        assert rel in paths, rel
    # the seam itself must NOT be pinned against its own time.* reads
    assert "src/repro_torch/obs/clock.py" not in paths


# ---- against the reference --------------------------------------------------------

import glob  # noqa: E402
import os  # noqa: E402

import pytest  # noqa: E402

import repro.analysis.lint as ref_lint  # noqa: E402

#: the fixture sources of tests/test_analysis_lint.py, and a few more
SOURCES = {
    "global_random": """\
        import random
        import numpy as np
        import numpy.random as npr
        from random import randint
        from numpy.random import shuffle
        x = random.random()
        np.random.shuffle([1, 2])
        npr.seed(0)
        random.seed(1)
    """,
    "seeded": """\
        import random
        import numpy as np
        rng = random.Random(0)
        g = np.random.default_rng(0)
        s = np.random.SeedSequence(1)
        from random import Random
    """,
    "wall_clock": """\
        import os
        import time
        import uuid
        import datetime as dtm
        from datetime import datetime
        from time import time_ns
        from os import urandom
        from uuid import uuid4
        a = time.time()
        b = datetime.now()
        c = os.urandom(8)
        d = uuid.uuid4()
        e = dtm.datetime.utcnow()
        f = dtm.date.today()
    """,
    "monotonic": """\
        import time
        t0 = time.perf_counter()
        t1 = time.monotonic()
        t2 = time.process_time()
    """,
    "unordered": """\
        import os
        from os import listdir
        for x in {1, 2}:
            pass
        ys = [y for y in set([3, 4])]
        zs = {z: 1 for z in frozenset([5])}
        for name in os.listdir("."):
            pass
        g = (n for n in listdir("."))
        ok = [w for w in sorted({1, 2})]
    """,
    "mutable_default": """\
        def f(x, cache={}):
            return x
        def g(x, items=[], *, k=dict()):
            return x
        async def h(x=set()):
            return x
        def fine(x=None, t=(), s="a"):
            return x
    """,
    "syntax_error": "def broken(:\n    pass\n",
    "boundary": """\
        import repro.core.fusion
        from repro.costmodel import something_else
        from repro.core import fusion
        import repro.core.graph
        import jax.numpy as jnp
        def lazy():
            from repro.costmodel.evaluator import Evaluator
            return Evaluator
    """,
    "clock_seam": """\
        import time
        import datetime
        from time import perf_counter
        from datetime import date
        t0 = time.perf_counter()
        now = time.time()
        stamp = datetime.datetime.now()
        d = date.today()
    """,
}
BOUNDARIES = {"mod.py": ["repro.core.fusion", "repro.costmodel.evaluator",
                         "jax"]}


def _key(f, config):
    """A finding without its message, the table file named alike."""
    return ("<tables>" if f.path == config else f.path, f.line, f.rule,
            f.symbol)


@pytest.mark.parametrize("name", list(SOURCES))
def test_findings_equal_the_references_on_fixture_sources(tmp_path, name):
    import textwrap
    (tmp_path / "mod.py").write_text(textwrap.dedent(SOURCES[name]))
    mine = lint_file(str(tmp_path / "mod.py"), "mod.py") \
        + check_boundaries(str(tmp_path), BOUNDARIES) \
        + check_clock_seam(str(tmp_path), ["mod.py", "gone.py"])
    ref = ref_lint.lint_file(str(tmp_path / "mod.py"), "mod.py") \
        + ref_lint.check_boundaries(str(tmp_path), BOUNDARIES) \
        + ref_lint.check_clock_seam(str(tmp_path), ["mod.py", "gone.py"])
    assert [_key(f, CONFIG) for f in mine] == \
        [_key(f, "pyproject.toml") for f in ref]
    assert mine, "every fixture finds something (gone.py at least)"


def test_run_lint_equals_the_references_on_one_tree(tmp_path):
    """One tree linted by both, each reading the same tables from its own
    file: an allowlisted hit, a stale and a malformed entry, a boundary
    row, a clock-seam row and a row naming a missing file."""
    import textwrap
    for pkg in ("repro", "repro_torch"):
        core = tmp_path / "src" / pkg / "core"
        core.mkdir(parents=True)
        (core / "a.py").write_text(textwrap.dedent(SOURCES["wall_clock"]))
        (core / "b.py").write_text(textwrap.dedent(SOURCES["unordered"]))
        (core / "c.py").write_text(textwrap.dedent(SOURCES["boundary"]))
    tables = textwrap.dedent("""\
        [tool.repro.lint]
        allow = [
            "src/{p}/core/a.py::wall-clock::os.urandom::fixture entropy read",
            "src/{p}/core/gone.py::wall-clock::time.time::was needed once",
            "only::three::fields",
        ]

        [tool.repro.lint.clock_seam]
        paths = [
            "src/{p}/core/a.py",
        ]

        [tool.repro.lint.boundaries]
        "src/{p}/core/c.py" = ["repro.core.fusion", "jax"]
        "src/{p}/core/missing.py" = ["repro.core.fusion"]
    """)
    (tmp_path / "pyproject.toml").write_text(tables.format(p="repro"))
    (tmp_path / CONFIG).write_text(tables.format(p="repro_torch"))
    mine = run_lint(str(tmp_path))
    ref = ref_lint.run_lint(str(tmp_path))

    def norm(findings, config, pkg):
        return sorted(tuple(x.replace(f"src/{pkg}/", "src/<pkg>/")
                            if isinstance(x, str) else x
                            for x in _key(f, config)) for f in findings)
    assert norm(mine, CONFIG, "repro_torch") == \
        norm(ref, "pyproject.toml", "repro")
    assert {f.rule for f in mine} >= {"wall-clock", "unordered-iter",
                                      "import-boundary", "clock-seam",
                                      "stale-allow", "bad-allow"}


def test_every_linted_port_file_is_pinned_against_repro_and_jax():
    table = load_pyproject_boundaries(CONFIG)
    linted = sorted(glob.glob("src/repro_torch/*/*.py"))
    linted = [p for p in linted
              if p.split(os.sep)[2] in ("core", "search", "serve",
                                        "costmodel", "ir", "hw", "obs",
                                        "analysis", "roofline")]
    assert len(linted) > 40
    for rel in linted + ["src/repro_torch/__main__.py"]:
        assert {"repro", "jax"} <= set(table.get(rel, ())), rel
    # and the pins bite: the reference's own modules import repro
    findings = check_boundaries(".", {"src/repro/serve/daemon.py":
                                      ["repro", "jax"]})
    assert findings and {f.symbol for f in findings} == {"repro"}


def test_cli_lint_is_clean_on_the_ports_tree(capsys):
    from repro_torch.__main__ import main
    assert main(["lint"]) == 0
    assert capsys.readouterr().out.strip() == "determinism lint: clean"
