"""The port's telemetry (``repro_torch.obs``) against the reference's.

The unit scenarios of ``tests/test_obs.py`` (instruments, registry, tracer,
trace aggregation, collector window math, the summary renderer) run on both
packages' modules: the port must pass the reference's assertions and give
the reference's output on the same inputs (trace events compared without
their pids, ids and timestamps).  Then the search-level checks of
``tests/test_obs_search.py`` on the port (``device="cpu"``): telemetry never
changes a fixed-seed result or the RNG draw sequence, the observer ticks in
order, traced runs emit one ``generation`` span per history entry, and the
island backend counts its barriers and migrations.  Last, the summary a
port search embeds equals the reference's in every field that is not a
clock (and the engine's name).
"""
import io
import json
import math
import os
import random
import types

import pytest

import repro.obs as R
import repro.obs.metrics as R_metrics
import repro.obs.report as R_report
import repro.obs.traceview as R_view
import repro_torch.obs as T
import repro_torch.obs.metrics as T_metrics
import repro_torch.obs.report as T_report
import repro_torch.obs.traceview as T_view
from repro.search import search as ref_search
from repro_torch.search import (ScheduleArtifact, SearchSession, SearchSpec,
                                search)

PKGS = {
    "port": types.SimpleNamespace(obs=T, metrics=T_metrics, report=T_report,
                                  view=T_view),
    "ref": types.SimpleNamespace(obs=R, metrics=R_metrics, report=R_report,
                                 view=R_view),
}
FAST = {"preset": "fast", "generations": 6}


def both(scenario):
    """The scenario's result on the port, asserted equal to the
    reference's."""
    got, want = scenario(PKGS["port"]), scenario(PKGS["ref"])
    assert got == want
    return got


def events(buf: io.StringIO):
    return [json.loads(line) for line in buf.getvalue().splitlines()]


def shape(evs):
    """Events without what differs by process and moment: pid, timestamps
    and durations; span ids renumbered in order of appearance."""
    ids = {}
    out = []
    for e in evs:
        e = {k: v for k, v in e.items()
             if k not in ("pid", "t0", "ts", "dur_s")}
        for k in ("id", "parent"):
            if e.get(k) is not None:
                e[k] = ids.setdefault(e[k], len(ids) + 1)
        out.append(e)
    return out


# ---- instruments ------------------------------------------------------------------

def test_counter_gauge_histogram_basics():
    def scenario(p):
        c = p.metrics.Counter()
        c.inc()
        c.inc(4)
        g = p.metrics.Gauge()
        g.set(2)
        g.set(0.25)
        h = p.metrics.Histogram()
        for v in (1.0, 3.0, 0.5):
            h.observe(v)
        return c.snapshot(), g.snapshot(), h.snapshot()
    c, g, s = both(scenario)
    assert c == 5 and g == 0.25
    assert s["count"] == 3 and s["total"] == 4.5
    assert s["min"] == 0.5 and s["max"] == 3.0
    assert s["mean"] == pytest.approx(1.5)


def test_histogram_buckets_are_power_of_two_magnitudes():
    def scenario(p):
        h = p.metrics.Histogram()
        for v in (1.0, 2.0, 3.0, 0.0):
            h.observe(v)
        return h.snapshot()
    s = both(scenario)
    assert s["buckets"] == {"0": 1, "1": 1, "2": 2}
    json.dumps(s, sort_keys=True)


def test_empty_histogram_snapshot_has_no_infinities():
    s = both(lambda p: p.metrics.Histogram().snapshot())
    assert s == {"count": 0, "total": 0.0, "min": 0.0, "max": 0.0,
                 "mean": 0.0, "buckets": {}}
    assert math.isfinite(s["min"]) and math.isfinite(s["max"])


def test_registry_get_or_create_and_labels():
    reg = T.MetricRegistry()
    assert reg.counter("a") is reg.counter("a")
    assert reg.counter("a", x="1") is not reg.counter("a", x="2")
    assert reg.counter("b", x="1", y="2") is reg.counter("b", y="2", x="1")
    assert len(reg) == 4


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_registry_rejects_type_conflict_on_one_series(pkg):
    reg = PKGS[pkg].obs.MetricRegistry()
    reg.counter("n")
    with pytest.raises(TypeError, match="one series, one instrument type"):
        reg.gauge("n")


def test_registry_snapshot_shape_and_series_names():
    def scenario(p):
        reg = p.obs.MetricRegistry()
        reg.counter("evals", engine="cuda").inc(3)
        reg.gauge("rate").set(0.5)
        reg.histogram("lat").observe(2.0)
        return reg.snapshot(), p.metrics.series_name(
            "x", (("a", "1"), ("b", "2")))
    snap, name = both(scenario)
    assert snap["counters"] == {"evals{engine=cuda}": 3}
    assert snap["gauges"] == {"rate": 0.5}
    assert snap["histograms"]["lat"]["count"] == 1
    assert name == "x{a=1,b=2}"


def test_null_registry_is_inert():
    i = T.NULL_REGISTRY.counter("x", any_label="y")
    i.inc()
    i.set(3.0)
    i.observe(1.0)
    assert len(T.NULL_REGISTRY) == 0
    assert T.NULL_REGISTRY.snapshot() == R.NULL_REGISTRY.snapshot() == {
        "counters": {}, "gauges": {}, "histograms": {}}


# ---- tracer -----------------------------------------------------------------------

def test_span_context_manager_nests_and_validates():
    def scenario(p):
        buf = io.StringIO()
        tr = p.obs.Tracer(stream=buf)
        with tr.span("outer", {"k": 1}):
            with tr.span("inner"):
                tr.point("tick", attrs={"n": 2})
        evs = events(buf)
        assert all(p.obs.validate_event(e) == [] for e in evs)
        assert all(e["pid"] == os.getpid() for e in evs)
        return shape(evs)
    point, inner, outer = both(scenario)
    assert [point["name"], inner["name"], outer["name"]] == \
        ["tick", "inner", "outer"]
    assert point["parent"] == inner["id"] and inner["parent"] == outer["id"]
    assert outer["parent"] is None and outer["attrs"] == {"k": 1}


def test_retroactive_emit_with_preallocated_id():
    def scenario(p):
        buf = io.StringIO()
        tr = p.obs.Tracer(stream=buf)
        gen = tr.alloc_id()
        tr.push(gen)
        tr.emit_span("child", t0=1.0, dur_s=0.5)
        tr.pop()
        tr.emit_span("gen", t0=0.0, dur_s=2.0, span_id=gen, parent=None)
        evs = events(buf)
        assert evs[0]["parent"] == gen and evs[1]["id"] == gen
        return shape(evs)
    child, gen = both(scenario)
    assert child["parent"] == gen["id"]


def test_tracer_stack_and_borrowed_stream():
    tr = T.Tracer(stream=io.StringIO())
    assert tr.current() is None and tr.pop() is None
    buf = io.StringIO()
    T.Tracer(stream=buf).close()
    assert not buf.closed
    with pytest.raises(ValueError, match="path or a stream"):
        T.Tracer()


def test_tracer_file_lines_append_and_validate(tmp_path):
    p = tmp_path / "t.jsonl"
    t1 = T.Tracer(str(p))
    t1.emit_span("a", t0=0.0, dur_s=0.1)
    t1.close()
    t2 = T.Tracer(str(p))
    t2.point("b")
    t2.close()
    lines = p.read_text().splitlines()
    assert len(lines) == 2
    # the reference reads the port's trace lines
    assert [R.validate_event(json.loads(ln)) for ln in lines] == [[], []]


def test_validate_event_rejects_schema_drift():
    good = {"v": T.SCHEMA_VERSION, "pid": 1, "ev": "span", "name": "x",
            "id": 3, "parent": None, "t0": 0.0, "dur_s": 0.1, "attrs": {}}
    point = {"v": T.SCHEMA_VERSION, "pid": 1, "ev": "point", "name": "p",
             "parent": None, "ts": 1.0, "attrs": {}}
    cases = [good, "nope", {**good, "v": 99}, {**good, "rogue": 1},
             {**good, "ev": "blip"}, {**good, "dur_s": -1.0},
             {**good, "pid": True}, {**good, "parent": 0}, point,
             {**point, "dur_s": 0.1}]
    got = [T.validate_event(c) for c in cases]
    assert got == [R.validate_event(c) for c in cases]
    assert got[0] == [] and got[8] == []
    assert got[1] == ["event is not a JSON object"]
    assert all(got[i] for i in (2, 3, 4, 5, 6, 7, 9))


def test_null_tracer_is_inert():
    nt = T.NULL_TRACER
    assert nt.enabled is False
    with nt.span("x") as sid:
        assert sid is None
    assert nt.emit_span("x") == 0 and nt.alloc_id() == 0
    nt.point("x")
    nt.push(1)
    assert nt.pop() is None and nt.current() is None
    nt.close()


def test_clock_seam_surface():
    assert isinstance(T.clock.unix_time(), int)
    a = T.clock.perf_counter()
    assert T.clock.perf_counter() >= a
    assert T.clock.now() > 1_600_000_000.0


# ---- trace aggregation ------------------------------------------------------------

def _write_search_trace(p, path):
    tr = p.obs.Tracer(str(path))
    with tr.span("search"):
        for dur in (0.2, 0.4):
            with tr.span("generation"):
                tr.emit_span("batch_eval", t0=0.0, dur_s=dur)
        snap = {"counters": {"eval.states": 10}, "gauges": {},
                "histograms": {"eval.batch_s":
                               p.metrics.Histogram().snapshot()}}
        tr.point("metrics.snapshot", attrs=snap)
    tr.close()


def _agg(rep):
    """The aggregate without its clock fields (the outer spans' measured
    durations) and the file path."""
    d = rep.to_dict()
    d.pop("path")
    d["tree"] = [{k: v for k, v in row.items()
                  if row["path"] == "search/generation/batch_eval"
                  or k not in ("total_s", "max_s")} for row in d["tree"]]
    d["slowest"] = [(s["name"], s["dur_s"]) for s in d["slowest"]
                    if s["name"] == "batch_eval"]
    return d


def test_read_trace_tree_slowest_and_metrics(tmp_path):
    """One trace file, aggregated by both packages' ``read_trace``."""
    _write_search_trace(PKGS["port"], tmp_path / "t.jsonl")
    rep = T_view.read_trace(str(tmp_path / "t.jsonl"), top=6)
    assert _agg(rep) == _agg(R_view.read_trace(str(tmp_path / "t.jsonl"),
                                               top=6))
    assert rep.valid and rep.n_events == 6
    assert rep.span_counts == {"search": 1, "generation": 2, "batch_eval": 2}
    paths = {row["path"]: row for row in rep.tree}
    assert paths["search/generation/batch_eval"]["count"] == 2
    assert paths["search/generation/batch_eval"]["max_s"] == 0.4
    assert rep.point_counts == {"metrics.snapshot": 1}
    assert rep.metrics["counters"] == {"eval.states": 10}
    d = json.loads(json.dumps(rep.to_dict()))
    assert d["valid"] and d["span_counts"]["generation"] == 2


def test_read_trace_merges_snapshots_across_processes(tmp_path):
    p = tmp_path / "t.jsonl"
    tr = T.Tracer(str(p))
    h1, h2 = T_metrics.Histogram(), T_metrics.Histogram()
    h1.observe(1.0)
    h2.observe(4.0)
    tr.point("metrics.snapshot", attrs={
        "counters": {"eval.states": 3}, "gauges": {"g": 1.0},
        "histograms": {"h": h1.snapshot()}})
    tr.point("metrics.snapshot", attrs={
        "counters": {"eval.states": 5}, "gauges": {"g": 2.0},
        "histograms": {"h": h2.snapshot()}})
    tr.close()
    rep = T_view.read_trace(str(p))
    assert rep.metrics == R_view.read_trace(str(p)).metrics
    assert rep.metrics["counters"]["eval.states"] == 8
    assert rep.metrics["gauges"]["g"] == 2.0
    h = rep.metrics["histograms"]["h"]
    assert h["count"] == 2 and h["min"] == 1.0 and h["max"] == 4.0
    assert h["mean"] == pytest.approx(2.5)


def test_read_trace_invalid_lines_and_orphans(tmp_path):
    p = tmp_path / "t.jsonl"
    tr = T.Tracer(str(p))
    tr.emit_span("ok", t0=0.0, dur_s=0.1)
    tr.emit_span("batch_eval", t0=0.0, dur_s=0.1, parent=12345)
    tr.close()
    with open(p, "a") as f:
        f.write("not json at all\n")
        f.write(json.dumps({"v": 99, "pid": 1, "ev": "span"}) + "\n")
        f.write("\n")
    rep = T_view.read_trace(str(p))
    ref = R_view.read_trace(str(p))
    assert rep.to_dict() == ref.to_dict() and rep.describe() == ref.describe()
    assert not rep.valid and len(rep.errors) == 2
    assert rep.n_events == 2
    assert {row["path"] for row in rep.tree} == {"ok", "batch_eval"}
    assert "INVALID" in rep.describe()


# ---- collector --------------------------------------------------------------------

class FakeEvaluator:
    group_hits = 0
    group_misses = 0


def test_collector_window_math_and_generation_records():
    def scenario(p):
        col = p.obs.TelemetryCollector()
        ev = FakeEvaluator()
        col.bind_evaluator(ev)
        col.begin_search({"workload": "w"})
        col.record_batch(4, 3, [2.0, 0.0, 1.0, 1.0], "cuda", 0.0, 0.01, 2)
        ev.group_hits, ev.group_misses = 6, 2
        col.on_step(0, best=2.0, evals=3, offspring=4)
        col.on_step(1, best=2.0, evals=3, offspring=4)
        return (col.generations, col.registry.snapshot(),
                col.summary({"group_hit_rate": 0.75}))
    gens, snap, s = both(scenario)
    rec = gens[0]
    assert rec["batch_states"] == 4 and rec["batch_unique"] == 3
    assert rec["rejection_rate"] == pytest.approx(0.25)
    assert rec["mean"] == pytest.approx(1.0)
    assert rec["std"] == pytest.approx(math.sqrt(0.5))
    assert rec["group_hit_rate"] == pytest.approx(6 / 8)
    assert rec["novel_groups"] == 2
    assert gens[1]["batch_states"] == 0 and gens[1]["mean"] == 0.0
    assert snap["counters"]["eval.states"] == 4
    assert snap["counters"]["eval.invalid"] == 1
    assert snap["counters"]["eval.batches_by_engine{engine=cuda}"] == 1
    assert s["schema"] == 1 and s["steps"] == 2
    assert s["best"] == [2.0, 2.0] and s["rejection_rate"] == [0.25, 0.0]
    assert s["cache"]["group_hit_rate"] == 0.75


def test_collector_span_scaffolding_counts_generations():
    def scenario(p):
        buf = io.StringIO()
        col = p.obs.TelemetryCollector(tracer=p.obs.Tracer(stream=buf))
        col.bind_evaluator(FakeEvaluator())
        col.begin_search({"workload": "w", "seed": 0})
        col.record_batch(2, 2, [1.0, 1.5], "scalar", 0.0, 0.01, 1)
        col.on_step(0, best=1.5, evals=2, offspring=2)
        col.record_batch(2, 1, [1.5], "scalar", 0.0, 0.01, 0)
        col.on_step(1, best=1.5, evals=3, offspring=4)
        col.end_search({"unique_groups": 3})
        evs = events(buf)
        assert all(p.obs.validate_event(e) == [] for e in evs)
        out = shape(evs)
        for e in out:          # snapshot histograms hold measured seconds
            if e["name"] == "metrics.snapshot":
                e["attrs"] = sorted(e["attrs"]["counters"].items())
        return out
    evs = both(scenario)
    by_name = {}
    for e in evs:
        by_name.setdefault(e["name"], []).append(e)
    assert len(by_name["generation"]) == 2
    search_ev = by_name["search"][0]
    assert search_ev["attrs"]["steps"] == 2
    assert search_ev["attrs"]["cache"] == {"unique_groups": 3}
    assert all(g["parent"] == search_ev["id"]
               for g in by_name["generation"])
    cost = by_name["costmodel"][0]
    assert cost["parent"] == by_name["batch_eval"][0]["id"]


def test_collector_from_env(monkeypatch, tmp_path):
    monkeypatch.delenv(T.TRACE_ENV, raising=False)
    assert T.TRACE_ENV == R.TRACE_ENV == "REPRO_TRACE"
    assert T.trace_path_from_env() is None
    assert T.TelemetryCollector.from_env() is None
    monkeypatch.setenv(T.TRACE_ENV, "")
    assert T.TelemetryCollector.from_env() is None
    p = tmp_path / "env.jsonl"
    monkeypatch.setenv(T.TRACE_ENV, str(p))
    col = T.TelemetryCollector.from_env()
    assert col is not None and col.tracer.enabled
    col.tracer.point("hello")
    col.close()
    assert R.validate_event(json.loads(p.read_text())) == []


def test_collector_migration_and_certificate_hooks():
    class Cert:
        traffic_words = 100
        schedule_lb_words = 80
        graph_lb_words = 60
        gap_vs_schedule = 0.25
        gap_vs_graph = 0.666667

    def scenario(p):
        buf = io.StringIO()
        col = p.obs.TelemetryCollector(tracer=p.obs.Tracer(stream=buf))
        col.record_migration(2, best=1.2, islands=4, migration=False)
        col.record_migration(3, best=1.3, islands=4, migration=True)
        col.record_certificate("sha256:ab", Cert(), ok=True)
        snap = col.registry.snapshot()
        snap.pop("histograms")
        return snap, shape(events(buf))
    snap, evs = both(scenario)
    assert snap["counters"]["island.barriers"] == 2
    assert snap["counters"]["island.migrations"] == 1
    assert snap["counters"]["verify.artifacts{ok=true}"] == 1
    names = [e["name"] for e in evs]
    assert names.count("island.migration") == 1
    cert_ev = [e for e in evs if e["name"] == "verify.certificate"][0]
    assert cert_ev["attrs"]["gap_vs_schedule"] == 0.25


# ---- renderer ---------------------------------------------------------------------

def make_summary(n=6):
    return {
        "schema": 1, "steps": n,
        "best": [1.0 + 0.1 * i for i in range(n)],
        "mean": [0.8 + 0.1 * i for i in range(n)],
        "std": [0.1] * n,
        "rejection_rate": [0.5 / (i + 1) for i in range(n)],
        "group_hit_rate": [i / n for i in range(n)],
        "unique_states": [10 * (i + 1) for i in range(n)],
        "offspring": [12 * (i + 1) for i in range(n)],
        "cache": {"group_hit_rate": 0.9, "unique_groups": 42,
                  "pop_backend": "cuda", "batch_evals_per_sec": 5000.0},
        "metrics": {"counters": {"eval.states": 60, "eval.invalid": 9}},
    }


@pytest.mark.parametrize("summary", [
    make_summary(), make_summary(n=200), {"schema": 1, "steps": 0,
                                          "best": []}],
    ids=["six", "two_hundred", "empty"])
def test_render_telemetry_matches_the_reference(summary):
    out = both(lambda p: p.report.render_telemetry(summary))
    if summary["steps"] == 6:
        assert "6 steps, best 1.0000 -> 1.5000" in out
        assert "60 unique states" in out
        assert "unique_groups 42" in out and "engine cuda" in out
        assert "9 of 60 scored states were unschedulable (15.0%)" in out
        assert out.count("|#") == 6
    elif summary["steps"] == 200:
        rows = [ln for ln in out.splitlines() if "|" in ln]
        assert len(rows) == 20
        assert "     0  " in rows[0] and "   199  " in rows[-1]
    else:
        assert "no per-generation records" in out


# ---- against real searches (tests/test_obs_search.py, on the port) --------------

def signature(art):
    return (art.genome_mask, art.best_fitness, art.history,
            art.evaluations, art.offspring_evaluated,
            art.best.energy_pj, art.best.cycles)


BASE = dict(workload="mobilenet_v3", accelerator="simba", backend="ga",
            seed=0, backend_config=dict(FAST))


def test_fixed_seed_search_bit_identical_with_telemetry(tmp_path):
    off = search(**BASE, device="cpu")
    on = search(**BASE, telemetry=True, device="cpu")
    traced = SearchSession(SearchSpec(**BASE, telemetry=True),
                           trace_path=str(tmp_path / "t.jsonl"),
                           device="cpu").run()
    assert signature(on) == signature(off)
    assert signature(traced) == signature(off)
    assert off.telemetry is None
    assert on.telemetry is not None
    assert on.telemetry["steps"] == len(on.history)


def test_env_trace_activates_without_touching_the_spec(tmp_path,
                                                       monkeypatch):
    spec = SearchSpec(**BASE)
    monkeypatch.delenv("REPRO_TRACE", raising=False)
    off = SearchSession(spec, device="cpu").run()
    p = tmp_path / "env.jsonl"
    monkeypatch.setenv("REPRO_TRACE", str(p))
    traced = SearchSession(spec, device="cpu").run()
    assert signature(traced) == signature(off)
    assert T_view.read_trace(str(p)).valid
    assert "telemetry" not in spec.to_dict()
    assert traced.spec.to_json() == off.spec.to_json()


class RecordingRandom(random.Random):
    draws = None

    def random(self):
        v = super().random()
        RecordingRandom.draws.append(v)
        return v

    def getrandbits(self, k):
        v = super().getrandbits(k)
        RecordingRandom.draws.append((k, v))
        return v


def test_rng_draw_sequence_identical_with_telemetry(monkeypatch):
    monkeypatch.setattr(random, "Random", RecordingRandom)
    base = dict(BASE, backend_config={"preset": "fast", "generations": 3})

    def run_and_record(**kw):
        RecordingRandom.draws = []
        art = search(**base, **kw, device="cpu")
        return art, RecordingRandom.draws

    art_off, draws_off = run_and_record()
    art_on, draws_on = run_and_record(telemetry=True)
    assert draws_off and draws_on == draws_off
    assert signature(art_on) == signature(art_off)


def test_progress_callback_already_sees_the_generation_record():
    session = SearchSession(SearchSpec(**BASE, telemetry=True),
                            device="cpu")
    ticks = []

    def progress(p):
        recs = session.telemetry.generations
        ticks.append((p.step, len(recs), recs[-1]["step"],
                      recs[-1]["best"]))

    art = session.run(progress=progress)
    assert len(ticks) == len(art.history)
    for i, (step, n_recs, last_step, last_best) in enumerate(ticks):
        assert n_recs == i + 1
        assert last_step == step
        assert last_best == art.history[i]
    assert art.telemetry["unique_states"][-1] == art.evaluations


@pytest.mark.parametrize("stopper", [{"budget": 60}, {"patience": 2}])
def test_budget_and_patience_stop_identically_on_and_off(stopper):
    base = dict(BASE, backend_config={"preset": "fast", "generations": 200},
                **stopper)
    off = search(**base, device="cpu")
    on = search(**base, telemetry=True, device="cpu")
    assert len(off.history) < 200
    assert signature(on) == signature(off)
    assert on.telemetry["steps"] == len(off.history)


def test_traced_run_emits_schema_valid_spans_matching_history(tmp_path):
    p = tmp_path / "run.jsonl"
    art = SearchSession(SearchSpec(**BASE), trace_path=str(p),
                        device="cpu").run()
    with open(p) as f:
        evs = [json.loads(line) for line in f]
    assert evs and all(T.validate_event(e) == [] for e in evs)
    rep = T_view.read_trace(str(p))
    assert rep.valid
    assert rep.span_counts["search"] == 1
    assert rep.span_counts["generation"] == len(art.history)
    assert rep.span_counts["batch_eval"] >= len(art.history)
    assert rep.metrics["counters"]["eval.unique"] == art.evaluations
    t = art.telemetry
    assert t is not None and t["steps"] == len(art.history)
    for key in ("best", "mean", "std", "rejection_rate", "group_hit_rate",
                "unique_states", "offspring"):
        assert len(t[key]) == len(art.history), key
    assert t["best"] == [round(b, 6) for b in art.history]
    assert t["cache"]["unique_groups"] > 0
    # the engine's batches are named by the device of their label pass
    assert set(rep.metrics["counters"]) >= {
        "eval.batches_by_engine{engine=torch}"}


def test_artifact_round_trips_telemetry_and_report_renders():
    art = search(**BASE, telemetry=True, device="cpu")
    again = ScheduleArtifact.from_json(art.to_json())
    assert again.telemetry == art.telemetry
    out = T_report.render_telemetry(again.telemetry)
    assert f"{len(art.history)} steps" in out
    assert f"{art.evaluations} unique states" in out
    assert "unique_groups" in out


def test_island_thread_mode_counts_barriers_and_migrations(tmp_path):
    p = tmp_path / "island.jsonl"
    spec = SearchSpec(
        workload="mobilenet_v3", accelerator="simba", backend="island",
        seed=0, telemetry=True,
        backend_config={"preset": "fast", "generations": 7, "islands": 2,
                        "migrate_every": 3, "workers": "thread"})
    art = SearchSession(spec, trace_path=str(p), device="cpu").run()
    counters = art.telemetry["metrics"]["counters"]
    assert counters["island.barriers"] == 2
    assert counters["island.migrations"] == 2
    rep = T_view.read_trace(str(p))
    assert rep.valid
    assert rep.point_counts.get("island.migration") == 2


# ---- the embedded summary against the reference's -------------------------------

#: summary fields that are clocks or the engine's name
CLOCK_METRICS = ("eval.batch_s",)
CLOCK_CACHE = ("batch_time_s", "batch_evals_per_sec", "pop_backend")


def comparable_summary(t):
    t = json.loads(json.dumps(t))
    for k in CLOCK_CACHE:
        t["cache"].pop(k, None)
    for k in CLOCK_METRICS:
        t["metrics"]["histograms"].pop(k, None)
    counters = t["metrics"]["counters"]
    for k in list(counters):
        if k.startswith("eval.batches_by_engine"):
            engine = k[k.index("=") + 1:-1]
            counters[k.replace(engine, "<engine>"
                               if engine in ("numpy", "torch") else engine)
                     ] = counters.pop(k)
    return t


@pytest.mark.parametrize("kw", [
    dict(BASE),
    dict(BASE, workload="resnet50", accelerator="eyeriss", objective="energy",
         seed=1),
    dict(BASE, backend="island",
         backend_config={"preset": "fast", "generations": 7, "islands": 2,
                         "migrate_every": 3}),
    dict(BASE, backend="random", backend_config={"evaluations": 1500}),
], ids=["ga", "ga_energy", "island", "random"])
def test_telemetry_summary_equals_the_references(kw, tmp_path):
    """Every field that is not a clock (the per-generation curves, the
    counters, the cache stats) equals the reference's; a trace has one
    generation span per observer tick (``len(artifact.history)`` on the ga
    backend; a barrier of the island backend, a chunk of random's)."""
    ref = ref_search(**kw, telemetry=True)
    got = SearchSession(SearchSpec(**kw, telemetry=True),
                        trace_path=str(tmp_path / "t.jsonl"),
                        device="cpu").run()
    assert comparable_summary(got.telemetry) == \
        comparable_summary(ref.telemetry)
    assert got.telemetry["cache"]["pop_backend"] == "torch"
    rep = T_view.read_trace(str(tmp_path / "t.jsonl"))
    assert rep.valid
    assert rep.span_counts["generation"] == got.telemetry["steps"] \
        == ref.telemetry["steps"]
    if kw["backend"] == "ga":
        assert rep.span_counts["generation"] == len(got.history)
