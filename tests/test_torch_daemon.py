"""The port's daemon side (``repro_torch.serve``: queue, daemon, warm
start, store gc) on the CPU, against the reference's.

The first part is ``tests/test_daemon.py`` with the port's modules, every
search on ``device="cpu"`` (the port's default is the card): the persistent
queue (priorities, journal replay, dedup), the daemon over a real socket on
``127.0.0.1:0`` (submit/poll/cancel, restart replays the journal, zero-eval
store hits), warm-start pins and store GC.  The second part holds the port
to the reference on the same inputs: journals written by either package
replay in the other to the same jobs, states and next id; the warm-start
donor picked from a store the reference filled; the keys ``collect_garbage``
evicts from two copies of one store; the daemon's artifacts equal the
reference's direct-session artifacts under the same store keys; an island
job run from a daemon worker thread gives ``chip_smoke.py``'s
``ISLAND_RUNS``; no CPU daemon without ``device``.  Every daemon is stopped
in a ``finally`` (``stop`` joins its threads with a timeout), so a stuck
worker fails its test instead of stalling the run.
"""
import json
import os
import time
import urllib.error
import urllib.request

import pytest

from repro_torch.search import SearchSession, SearchSpec
from repro_torch.serve import (ArtifactStore, ScheduleDaemon, artifact_key,
                         collect_garbage, find_warm_start)
from repro_torch.serve.queue import JobQueue
from repro_torch.serve.warmstart import adapt_mask, workload_family

FAST = {"preset": "fast", "generations": 4}


def fast_spec(workload="vgg16", seed=0, generations=4, **kw):
    return SearchSpec(workload=workload, seed=seed,
                      backend_config={"preset": "fast",
                                      "generations": generations}, **kw)


# ---- JobQueue ---------------------------------------------------------------------

def spec_dict(seed=0, workload="vgg16"):
    return fast_spec(workload=workload, seed=seed).to_dict()


def test_queue_priority_order(tmp_path):
    q = JobQueue(str(tmp_path))
    a = q.submit(spec_dict(seed=0), priority=0, key="ka")
    b = q.submit(spec_dict(seed=1), priority=5, key="kb")
    c = q.submit(spec_dict(seed=2), priority=1, key="kc")
    order = [q.next_job().id for _ in range(3)]
    assert order == [b.id, c.id, a.id]
    q.close()


def test_queue_ties_run_in_submission_order(tmp_path):
    q = JobQueue(str(tmp_path))
    ids = [q.submit(spec_dict(seed=i), key=f"k{i}").id for i in range(4)]
    assert [q.next_job().id for _ in range(4)] == ids
    q.close()


def test_queue_journal_replay_requeues_running_and_queued(tmp_path):
    q = JobQueue(str(tmp_path))
    a = q.submit(spec_dict(seed=0), priority=2, key="ka")
    b = q.submit(spec_dict(seed=1), priority=0, key="kb")
    started = q.next_job()
    assert started.id == a.id            # higher priority first
    q.close()                            # "crash": a was running, b queued

    q2 = JobQueue(str(tmp_path))
    assert q2.replay.jobs == 2
    assert q2.replay.requeued == 2       # running job re-runs from scratch
    assert {j.state for j in q2.list_jobs()} == {"queued"}
    # ids continue past the replayed ones
    c = q2.submit(spec_dict(seed=2), key="kc")
    assert c.id == b.id + 1
    q2.close()


def test_queue_replay_keeps_terminal_states(tmp_path):
    q = JobQueue(str(tmp_path))
    a = q.submit(spec_dict(seed=0), key="ka")
    assert q.next_job().id == a.id
    q.resolve_done(a.id, "searched", "ka")
    b = q.submit(spec_dict(seed=1), key="kb")
    assert q.cancel(b.id) == "cancelled"
    q.close()

    q2 = JobQueue(str(tmp_path))
    assert q2.get(a.id).state == "done"
    assert q2.get(a.id).outcome == "searched"
    assert q2.get(b.id).state == "cancelled"
    assert q2.replay.requeued == 0
    q2.close()


def test_queue_dedup_attaches_and_resolves_with_primary(tmp_path):
    q = JobQueue(str(tmp_path))
    a = q.submit(spec_dict(seed=0), key="same")
    b = q.submit(spec_dict(seed=0), key="same")
    assert b.attached_to == a.id
    assert q.next_job().id == a.id
    assert q.next_job(timeout=0.05) is None   # b never enters the heap
    q.resolve_done(a.id, "searched", "same")
    assert q.get(b.id).state == "done"
    assert q.get(b.id).outcome == "cache_hit"
    q.close()


def test_queue_dedup_failure_propagates(tmp_path):
    q = JobQueue(str(tmp_path))
    a = q.submit(spec_dict(seed=0), key="same")
    b = q.submit(spec_dict(seed=0), key="same")
    q.next_job()
    q.resolve_failed(a.id, "boom")
    assert q.get(b.id).state == "failed"
    assert q.get(b.id).error == "boom"
    q.close()


def test_queue_cancelled_primary_requeues_attached(tmp_path):
    q = JobQueue(str(tmp_path))
    a = q.submit(spec_dict(seed=0), key="same")
    b = q.submit(spec_dict(seed=0), key="same")
    assert q.next_job().id == a.id
    q.resolve_cancelled(a.id)
    nxt = q.next_job(timeout=1.0)
    assert nxt is not None and nxt.id == b.id  # request still stands
    q.close()


def test_queue_tolerates_torn_trailing_line(tmp_path):
    q = JobQueue(str(tmp_path))
    q.submit(spec_dict(seed=0), key="ka")
    q.close()
    with open(tmp_path / "queue.jsonl", "a") as f:
        f.write('{"v":1,"event":"sub')      # torn mid-crash write
    q2 = JobQueue(str(tmp_path))
    assert q2.replay.jobs == 1
    assert len(q2.replay.warnings) == 1
    q2.close()


def test_queue_live_keys_cover_non_terminal_jobs(tmp_path):
    q = JobQueue(str(tmp_path))
    a = q.submit(spec_dict(seed=0), key="ka")
    q.submit(spec_dict(seed=1), key="kb")
    q.next_job()
    q.resolve_done(a.id, "searched", "ka")
    assert q.live_keys() == {"kb"}
    q.close()


# ---- daemon over a real socket ----------------------------------------------------

def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as r:
        return json.load(r)


def _post(base, path, payload):
    req = urllib.request.Request(base + path,
                                 data=json.dumps(payload).encode())
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.load(r)


def _delete(base, path):
    req = urllib.request.Request(base + path, method="DELETE")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.load(r)


def _wait(base, jid, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        j = _get(base, f"/jobs/{jid}")
        if j["state"] in ("done", "failed", "cancelled"):
            return j
        time.sleep(0.05)
    raise AssertionError(f"job {jid} did not resolve: {j}")


@pytest.fixture()
def daemon(tmp_path):
    svc = ScheduleDaemon(str(tmp_path / "store"), workers=1, device="cpu")
    svc.start()
    try:
        yield svc, f"http://127.0.0.1:{svc.port}"
    finally:
        svc.stop()


def test_daemon_submit_poll_artifact_metrics(daemon):
    svc, base = daemon
    assert _get(base, "/healthz") == {"ok": True}
    job = _post(base, "/jobs", {"spec": fast_spec().to_dict()})
    assert job["state"] in ("queued", "running", "done")
    done = _wait(base, job["id"])
    assert done["outcome"] == "searched"
    assert done["key"]
    # live per-generation convergence records were served
    assert len(done["progress"]) == 4
    assert done["progress"][0]["step"] == 0
    assert done["summary"]["edp_x"] > 0
    art = _get(base, f"/artifacts/{done['key']}")
    assert art["genome_mask"] is not None
    m = _get(base, "/metrics")
    assert m["jobs"]["done"] == 1
    assert m["daemon"]["searches_run"] == 1
    assert m["metrics"]["counters"]["daemon.jobs{outcome=searched}"] == 1
    assert m["metrics"]["counters"]["eval.states"] > 0


def test_daemon_store_hit_serves_with_zero_new_evaluations(daemon):
    svc, base = daemon
    first = _wait(base, _post(base, "/jobs",
                              {"spec": fast_spec().to_dict()})["id"])
    evals_before = _get(base, "/metrics")["metrics"]["counters"]["eval.states"]
    dup = _post(base, "/jobs", {"spec": fast_spec().to_dict()})
    # resolved AT submission: no queueing, no search, no evaluator
    assert dup["state"] == "done"
    assert dup["outcome"] == "cache_hit"
    assert dup["key"] == first["key"]
    m = _get(base, "/metrics")
    assert m["metrics"]["counters"]["eval.states"] == evals_before
    assert svc.searches_run == 1
    assert svc.store_hits == 1


def test_daemon_404s(daemon):
    svc, base = daemon
    for path in ("/jobs/999", "/artifacts/" + "0" * 64, "/nope"):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(base, path)
        assert ei.value.code == 404


def test_daemon_bad_spec_is_400(daemon):
    svc, base = daemon
    for payload in ({}, {"spec": {"workload": "no_such_net"}},
                    {"spec": {"workload": "vgg16", "bogus_field": 1}}):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, "/jobs", payload)
        assert ei.value.code == 400


def test_daemon_cancel_running_job_cooperatively(daemon):
    svc, base = daemon
    # enough generations that the cancel lands mid-search
    job = _post(base, "/jobs", {"spec": fast_spec(
        workload="unet", generations=100000).to_dict()})
    deadline = time.monotonic() + 60
    while _get(base, f"/jobs/{job['id']}")["state"] != "running":
        assert time.monotonic() < deadline, "job never started"
        time.sleep(0.02)
    out = _delete(base, f"/jobs/{job['id']}")
    assert out["state"] in ("cancelling", "cancelled")
    final = _wait(base, job["id"])
    assert final["state"] == "cancelled"
    # a repeat DELETE reports the job as already resolved (409)
    with pytest.raises(urllib.error.HTTPError) as ei:
        _delete(base, f"/jobs/{job['id']}")
    assert ei.value.code == 409


def test_daemon_cancel_queued_job(tmp_path):
    svc = ScheduleDaemon(str(tmp_path / "store"), workers=0, device="cpu")
    svc.start()
    base = f"http://127.0.0.1:{svc.port}"
    try:
        job = _post(base, "/jobs", {"spec": fast_spec().to_dict()})
        assert job["state"] == "queued"
        assert _delete(base, f"/jobs/{job['id']}")["state"] == "cancelled"
        assert _get(base, f"/jobs/{job['id']}")["state"] == "cancelled"
    finally:
        svc.stop()


def test_daemon_restart_replays_journal(tmp_path):
    store_dir = str(tmp_path / "store")
    svc = ScheduleDaemon(store_dir, workers=0,       # nothing drains
                         device="cpu")
    svc.start()
    base = f"http://127.0.0.1:{svc.port}"
    j0 = _post(base, "/jobs", {"spec": fast_spec(seed=0).to_dict(),
                               "priority": 1})
    j1 = _post(base, "/jobs", {"spec": fast_spec(seed=1).to_dict(),
                               "priority": 5})
    svc.stop()                                   # jobs still queued

    svc2 = ScheduleDaemon(store_dir, workers=1, device="cpu")
    assert svc2.queue.replay.requeued == 2
    svc2.start()
    base2 = f"http://127.0.0.1:{svc2.port}"
    try:
        done1 = _wait(base2, j1["id"])
        done0 = _wait(base2, j0["id"])
        assert done0["outcome"] == "searched"
        assert done1["outcome"] == "searched"
        assert svc2.searches_run == 2
    finally:
        svc2.stop()


def test_daemon_inflight_dedup_one_search_serves_both(tmp_path):
    store_dir = str(tmp_path / "store")
    svc = ScheduleDaemon(store_dir, workers=0,       # hold both queued
                         device="cpu")
    svc.start()
    base = f"http://127.0.0.1:{svc.port}"
    ja = _post(base, "/jobs", {"spec": fast_spec().to_dict()})
    jb = _post(base, "/jobs", {"spec": fast_spec().to_dict()})
    assert not ja["deduped"]
    assert jb["deduped"]                          # attached in-flight
    svc.stop()

    svc2 = ScheduleDaemon(store_dir, workers=1, device="cpu")
    svc2.start()
    base2 = f"http://127.0.0.1:{svc2.port}"
    try:
        da = _wait(base2, ja["id"])
        db = _wait(base2, jb["id"])
        assert da["key"] == db["key"]
        assert svc2.searches_run == 1             # exactly one search
        assert {da["outcome"], db["outcome"]} == {"searched", "cache_hit"}
    finally:
        svc2.stop()


# ---- warm-start pins --------------------------------------------------------------

def test_daemon_default_results_bit_identical_to_direct_session(tmp_path):
    spec = fast_spec()
    direct = SearchSession(spec, device="cpu").run()

    svc = ScheduleDaemon(str(tmp_path / "store"), workers=1, device="cpu")
    svc.start()
    base = f"http://127.0.0.1:{svc.port}"
    try:
        done = _wait(base, _post(base, "/jobs",
                                 {"spec": spec.to_dict()})["id"])
        via_daemon = svc.store.load_key(done["key"])
    finally:
        svc.stop()
    # same fixed-seed trajectory, same store key, byte-identical payload
    # minus wall-clock provenance (wall_s, created_unix, and the timing
    # rates inside backend_stats are the only fields a clock feeds)
    assert done["key"] == artifact_key(direct.graph_fingerprint, spec)
    a, b = direct.to_dict(), via_daemon.to_dict()
    for d in (a, b):
        d.pop("wall_s"), d.pop("created_unix")
        for k in ("batch_time_s", "batch_evals_per_sec"):
            d["backend_stats"].pop(k, None)
    assert a == b


def test_warm_start_seeds_first_generation_at_or_above_cold(tmp_path):
    donor_spec = fast_spec(seed=0, generations=12)
    cold_spec = fast_spec(seed=7)
    cold = SearchSession(cold_spec, device="cpu").run()

    svc = ScheduleDaemon(str(tmp_path / "store"), workers=1, device="cpu")
    svc.start()
    base = f"http://127.0.0.1:{svc.port}"
    try:
        donor = _wait(base, _post(base, "/jobs",
                                  {"spec": donor_spec.to_dict()})["id"])
        warm_job = _wait(base, _post(
            base, "/jobs",
            {"spec": cold_spec.to_dict(), "warm_start": True})["id"])
        warm = svc.store.load_key(warm_job["key"])
        donor_art = svc.store.load_key(donor["key"])
    finally:
        svc.stop()
    assert warm_job["outcome"] == "searched"
    # the donor's converged winner joins the initial pool, so the warm
    # run's first generation can never be worse than it — and must be at
    # least as good as the cold run's first generation
    assert warm.history[0] >= donor_art.best_fitness - 1e-9
    assert warm.history[0] >= cold.history[0] - 1e-9
    # warm-starting never changes the request's identity
    assert warm_job["key"] == artifact_key(cold.graph_fingerprint, cold_spec)


def test_warm_start_ranking_prefers_same_fingerprint(tmp_path):
    store = ArtifactStore(str(tmp_path))
    exact = SearchSession(fast_spec(seed=0), device="cpu").run()
    other = SearchSession(fast_spec(workload="unet", seed=0),
                          device="cpu").run()
    store.put(exact)
    store.put(other)
    seed = find_warm_start(store, exact.graph_fingerprint, fast_spec(seed=3))
    assert seed is not None and seed.exact
    assert seed.mask == exact.genome_mask
    # family match: same workload name, different params -> inexact donor
    fam = find_warm_start(store, "sha256:elsewhere",
                          fast_spec(workload="vgg16@hw=160", seed=0))
    assert fam is not None and not fam.exact
    assert workload_family("vgg16@hw=160") == "vgg16"
    # no donor at all for an unknown family
    assert find_warm_start(store, "sha256:x",
                           fast_spec(workload="resnet50")) is None


def test_adapt_mask_clips_to_edge_range():
    assert adapt_mask(0b1011, 2) == 0b11
    assert adapt_mask(0b1011, 8) == 0b1011
    assert adapt_mask(0b1011, 0) == 0


def test_seed_genomes_default_empty_keeps_ga_identical():
    # belt and braces on top of the byte-identity test above: the seeding
    # hook's empty default must leave run_ga_problem's draws untouched
    from repro_torch.core.ga import GAConfig, run_ga_problem
    from repro_torch.core.problem import FusionProblem, SearchProblem
    from repro_torch.search.registry import build_accelerator, build_workload
    from repro_torch.costmodel.evaluator import Evaluator

    assert SearchProblem.seed_genomes == ()
    graph = build_workload("vgg16")
    cfg = GAConfig.fast(generations=3)
    r1 = run_ga_problem(FusionProblem(
        graph, Evaluator(graph, build_accelerator("simba"), device="cpu")),
        cfg)
    p2 = FusionProblem(graph, Evaluator(graph, build_accelerator("simba"),
                                        device="cpu"))
    p2.seed_genomes = ()                 # explicit empty == absent
    r2 = run_ga_problem(p2, cfg)
    assert r1.history == r2.history
    assert r1.best_state.mask == r2.best_state.mask
    assert r1.evaluations == r2.evaluations


# ---- store GC ---------------------------------------------------------------------

def _store_with_artifacts(root, n=4):
    store = ArtifactStore(str(root))
    keys = []
    for seed in range(n):
        art = SearchSession(fast_spec(seed=seed, generations=1),
                            device="cpu").run()
        keys.append(store.put(art))
    return store, keys


def test_gc_evicts_least_recently_used_first(tmp_path):
    store, keys = _store_with_artifacts(tmp_path, n=4)
    now = time.time()
    for i, key in enumerate(keys):       # keys[0] oldest access
        os.utime(store.path_for(key), (now - 1000 + i, now - 1000 + i))
    res = collect_garbage(store, max_objects=2, live=frozenset())
    assert res.evicted == keys[:2]
    assert sorted(store.keys()) == sorted(keys[2:])


def test_gc_never_evicts_live_keys(tmp_path):
    store, keys = _store_with_artifacts(tmp_path, n=3)
    now = time.time()
    for i, key in enumerate(keys):
        os.utime(store.path_for(key), (now - 1000 + i, now - 1000 + i))
    res = collect_garbage(store, max_objects=1, live={keys[0]})
    assert keys[0] not in res.evicted
    assert keys[0] in res.kept_live
    assert os.path.isfile(store.path_for(keys[0]))


def test_gc_respects_max_bytes(tmp_path):
    store, keys = _store_with_artifacts(tmp_path, n=3)
    sizes = {k: os.path.getsize(store.path_for(k)) for k in keys}
    budget = sizes[keys[1]] + sizes[keys[2]]
    res = collect_garbage(store, max_bytes=budget, live=frozenset())
    remaining = sum(os.path.getsize(store.path_for(k))
                    for k in store.keys())
    assert remaining <= budget
    assert res.evicted_bytes > 0


def test_gc_reports_corrupt_objects_without_deleting(tmp_path):
    store, keys = _store_with_artifacts(tmp_path, n=2)
    bad = store.path_for(keys[0])
    with open(bad, "w") as f:
        f.write("{not json")
    res = collect_garbage(store, max_objects=0, live=frozenset())
    assert keys[0] in res.corrupt
    assert os.path.isfile(bad)           # reported, not deleted
    assert keys[1] in res.evicted        # the healthy object still evicts


def test_gc_dry_run_deletes_nothing(tmp_path):
    store, keys = _store_with_artifacts(tmp_path, n=2)
    res = collect_garbage(store, max_objects=0, live=frozenset(),
                          dry_run=True)
    assert len(res.evicted) == 2
    assert sorted(store.keys()) == sorted(keys)


def test_gc_pins_keys_from_queue_journal(tmp_path):
    store, keys = _store_with_artifacts(tmp_path, n=2)
    q = JobQueue(str(tmp_path))          # journal in the store dir
    q.submit(spec_dict(seed=0), key=keys[0])
    q.close()
    res = collect_garbage(store, max_objects=0)
    assert keys[0] in res.kept_live
    assert keys[1] in res.evicted


def test_store_hit_refreshes_lru_clock(tmp_path):
    store, keys = _store_with_artifacts(tmp_path, n=1)
    art = store.load_key(keys[0])
    path = store.path_for(keys[0])
    os.utime(path, (1000.0, 1000.0))
    store.get(art.graph_fingerprint, art.spec)
    assert os.path.getmtime(path) > 1000.0


# ---- against the reference --------------------------------------------------------

import importlib.util  # noqa: E402
import shutil  # noqa: E402
from pathlib import Path  # noqa: E402

import repro.serve as rv  # noqa: E402
from repro.search import SearchSession as RefSession  # noqa: E402
from repro.search import SearchSpec as RefSpec  # noqa: E402
from repro.serve.queue import JobQueue as RefQueue  # noqa: E402

import repro_torch.search.island as island  # noqa: E402
from repro_torch.serve import live_keys_for_store  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CLOCKS = ("created_unix", "wall_s")
ENGINE_STATS = ("batch_time_s", "batch_evals_per_sec", "pop_backend")


def _comparable(art) -> dict:
    d = json.loads(json.dumps(art.to_dict()))
    for key in CLOCKS:
        del d[key]
    for key in ENGINE_STATS:
        d["backend_stats"].pop(key, None)
    return d


def _queue_state(q) -> dict:
    return {"jobs": [j.to_dict() for j in q.list_jobs()],
            "replay": (q.replay.jobs, q.replay.requeued, q.replay.terminal,
                       len(q.replay.warnings)),
            "next_id": q._next_id, "live": sorted(q.live_keys()),
            "counts": q.counts()}


def _write_journal(queue_cls, root) -> None:
    """Every kind of journal line: priorities, a dedup, a start, each
    resolution, a cancel, a job left running, and a torn last line."""
    q = queue_cls(str(root))
    a = q.submit(spec_dict(seed=0), priority=2, key="ka")
    q.submit(spec_dict(seed=0), key="ka")                 # attaches to a
    b = q.submit(spec_dict(seed=1), priority=5, key="kb")
    c = q.submit(spec_dict(seed=2), key="kc", warm_start=True)
    d = q.submit(spec_dict(seed=3), key="kd")
    q.submit(spec_dict(seed=4), key="ke", resolved=("cache_hit", "ke"))
    assert q.next_job().id == b.id
    q.resolve_done(b.id, "searched", "kb")
    assert q.next_job().id == a.id
    q.resolve_failed(a.id, "boom")
    assert q.cancel(d.id) == "cancelled"
    assert q.next_job().id == c.id                        # left running
    q.close()
    with open(root / "queue.jsonl", "a") as f:
        f.write('{"v":1,"event":"sub')


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_journals_replay_to_the_same_queue_in_either_package(tmp_path,
                                                             writer):
    _write_journal(JobQueue if writer == "port" else RefQueue, tmp_path)
    mine, ref = JobQueue(str(tmp_path)), RefQueue(str(tmp_path))
    try:
        assert _queue_state(mine) == _queue_state(ref)
        assert _queue_state(mine)["replay"] == (6, 1, 5, 1)
        # the replayed queues hand out the same job, then the same new id
        assert mine.next_job(timeout=0.05).id == \
            ref.next_job(timeout=0.05).id
        assert mine.next_job(timeout=0.05) is ref.next_job(timeout=0.05) \
            is None
        assert mine.submit(spec_dict(seed=9), key="kz").id == \
            ref.submit(spec_dict(seed=9), key="kz").id
    finally:
        mine.close()
        ref.close()


def _ref_store(root, specs):
    store = rv.ArtifactStore(str(root))
    keys = [store.put(RefSession(RefSpec(**kw)).run()) for kw in specs]
    return store, keys


WARM_DONORS = [
    dict(workload="vgg16", seed=0, backend_config=FAST),
    dict(workload="vgg16", seed=1, backend_config=dict(FAST, generations=8)),
    dict(workload="vgg16@hw=160", seed=0, backend_config=FAST),
    dict(workload="unet", seed=0, backend_config=FAST),
    dict(workload="vgg16", seed=2, objective="energy", backend_config=FAST),
]


@pytest.mark.parametrize("query", [
    dict(workload="vgg16", seed=5),
    dict(workload="vgg16@hw=128", seed=0),
    dict(workload="vgg16", seed=5, objective="energy"),
    dict(workload="vgg16@hw=128", accelerator="eyeriss"),
    dict(workload="resnet50"),
])
def test_warm_start_picks_the_references_donor(tmp_path, query):
    store, _ = _ref_store(tmp_path, WARM_DONORS)
    mine_store = ArtifactStore(str(tmp_path), create=False)
    from repro.search.artifact import graph_fingerprint as ref_fp
    from repro.search.registry import build_workload as ref_build
    fingerprint = ref_fp(ref_build(query["workload"]))
    want = rv.find_warm_start(store, fingerprint, RefSpec(**query))
    got = find_warm_start(mine_store, fingerprint, SearchSpec(**query))
    assert (got is None) == (want is None)
    if want is not None:
        assert got.__dict__ == want.__dict__


@pytest.mark.parametrize("limits", [dict(max_objects=2),
                                    dict(max_objects=0),
                                    dict(max_bytes=1)], ids=str)
def test_gc_evicts_the_references_keys_and_never_a_live_one(tmp_path,
                                                             limits):
    _, keys = _ref_store(tmp_path / "a", WARM_DONORS[:4])
    q = RefQueue(str(tmp_path / "a"))     # a queued job pins keys[1]
    q.submit(spec_dict(seed=0), key=keys[1])
    q.close()
    (tmp_path / "a" / "objects" / keys[3][:2] / f"{keys[3]}.json"
     ).write_text("{not json")
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    for copy in ("a", "b"):                # equal mtimes in both copies
        for i, key in enumerate(keys):
            path = tmp_path / copy / "objects" / key[:2] / f"{key}.json"
            os.utime(path, (1000.0 + i, 1000.0 + i))
    assert live_keys_for_store(str(tmp_path / "b")) == {keys[1]}
    want = rv.collect_garbage(rv.ArtifactStore(str(tmp_path / "a")),
                              **limits).to_dict()
    got = collect_garbage(ArtifactStore(str(tmp_path / "b")),
                          **limits).to_dict()
    assert got == want
    assert keys[1] in got["kept_live"] and keys[1] not in got["evicted"]
    assert got["corrupt"] == [keys[3]] and got["evicted"]
    assert sorted(p.name for p in (tmp_path / "b").rglob("*.json")) == \
        sorted(p.name for p in (tmp_path / "a").rglob("*.json"))


DAEMON_SPECS = [
    dict(workload="mobilenet_v3", seed=0,
         backend_config={"preset": "fast", "generations": 6}),
    dict(workload="resnet50", accelerator="eyeriss", backend="random",
         backend_config={"evaluations": 2000}),
    dict(workload="vgg16", backend="exhaustive", spacemap=True),
    dict(workload="mobilenet_v3", spacemap=True, objective="energy",
         backend_config={"preset": "fast", "generations": 6}),
]


def test_daemon_artifacts_equal_the_references_direct_sessions(tmp_path):
    """Two workers search the four jobs at once: each stored artifact is
    the reference's direct-session artifact, under the same store key."""
    svc = ScheduleDaemon(str(tmp_path / "store"), workers=2, device="cpu")
    svc.start()
    base = f"http://127.0.0.1:{svc.port}"
    try:
        jobs = [_post(base, "/jobs", {"spec": SearchSpec(**kw).to_dict()})
                for kw in DAEMON_SPECS]
        done = [_wait(base, j["id"]) for j in jobs]
        arts = [svc.store.load_key(d["key"]) for d in done]
    finally:
        svc.stop()
    assert not any(t.is_alive() for t in svc._threads[1:])   # workers
    for kw, d, art in zip(DAEMON_SPECS, done, arts):
        ref = RefSession(RefSpec(**kw)).run()
        assert d["outcome"] == "searched"
        assert d["key"] == rv.artifact_key(ref.graph_fingerprint,
                                           RefSpec(**kw))
        assert _comparable(art) == _comparable(ref)
        # the per-region exhaustive run scores one genome at a time, off
        # the population engine
        assert art.backend_stats["pop_backend"] == (
            "off" if kw.get("backend") == "exhaustive" else "torch")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_island_job_in_a_worker_thread_gives_island_runs(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(island, "SYNC_TIMEOUT_S", 60.0)
    cs = _chip_smoke()
    spec = SearchSpec(**cs.ISLAND_SPEC, backend_config=cs.island_config(2))
    svc = ScheduleDaemon(str(tmp_path / "store"), workers=1, device="cpu")
    svc.start()
    base = f"http://127.0.0.1:{svc.port}"
    try:
        done = _wait(base, _post(base, "/jobs",
                                 {"spec": spec.to_dict()})["id"])
        art = svc.store.load_key(done["key"])
    finally:
        svc.stop()
    got = dict(genome_mask=art.genome_mask, best_fitness=art.best_fitness,
               history_len=len(art.history), evaluations=art.evaluations,
               offspring_evaluated=art.offspring_evaluated)
    assert got == cs.ISLAND_RUNS[2]


def test_daemon_without_a_card_or_device_raises(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ScheduleDaemon(str(tmp_path / "store"))
    assert not (tmp_path / "store").exists()


def test_label_launch_counts_are_exact_under_threads(monkeypatch):
    """The daemon's workers launch the label kernel from several threads:
    the totals and each thread's own tally (what an engine reads) lose no
    update.  The counting is the wrapper's, called as a launch calls it
    (the kernel itself runs only on the card)."""
    import sys
    import threading

    from repro_torch.kernels.ga_labels import ops
    monkeypatch.setattr(ops.ga_labels, "launches", 0)
    monkeypatch.setattr(ops.ga_labels, "variant_launches",
                        dict.fromkeys(ops.VARIANTS, 0))
    n_threads, per_thread = 16, 2000
    tallies = [None] * n_threads
    start = threading.Barrier(n_threads)

    def work(i):
        start.wait()
        before = ops.thread_launches()
        for j in range(per_thread):
            ops._count(ops.VARIANTS[j % 2])
        tallies[i] = ops.thread_launches() - before

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert tallies == [per_thread] * n_threads
    assert ops.ga_labels.launches == n_threads * per_thread
    assert ops.ga_labels.variant_launches == {
        "warp": n_threads * per_thread // 2,
        "block": n_threads * per_thread // 2, "global": 0}


def test_each_engine_counts_only_its_own_threads_launches(monkeypatch):
    """Two searches on two threads at once, as two daemon workers run them:
    each engine's ``label_launches`` is its own batches, never the other
    thread's launches (the label pass is made to count as it does on the
    card)."""
    import threading

    import repro_torch.core.population as population
    from repro_torch.kernels.ga_labels import ops

    def counting(bits, tables, **kw):
        out = ops.ga_labels(bits, tables, **kw)
        ops._count("warp")
        return out
    monkeypatch.setattr(population, "ga_labels", counting)
    sessions = [SearchSession(SearchSpec(**kw), device="cpu")
                for kw in DAEMON_SPECS[:2]]
    threads = [threading.Thread(target=s.run) for s in sessions]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for s in sessions:
        stats = s.evaluator._pop.stats()
        assert stats["batches"] > 0
        assert stats["label_launches"] == stats["batches"]
