"""The port's schedule store and batch scheduler (``repro_torch.serve``)
against the reference's (``repro.serve``).

Keys: both packages give the same ``spec_hash`` and ``artifact_key`` for the
same spec, bit for bit, and a store written by either package serves the
other's scheduler with ``cache_hit`` and zero evaluations.  Then the
reference's own store and scheduler tests (``tests/test_serve.py``) on the
port, its searches on the CPU (``device="cpu"``): round trips, atomic
concurrent writers, schema leniency, in-flight dedup, store hits that build
no session, the worker pool (``fork`` here) against inline runs, the island
backend inside the pool (its islands threads, as pool workers are daemonic)
and failure isolation.  The CLI verbs are in ``tests/test_torch_cli.py``.
"""
import json
import multiprocessing
import os

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.search as rs
import repro.serve as rv
import repro_torch.search.island as island
from repro_torch.costmodel.evaluator import ScheduleCost
from repro_torch.search import ScheduleArtifact, SearchSpec
from repro_torch.serve import (ArtifactStore, BatchScheduler, StoreError,
                               artifact_key, spec_hash)

FAST = {"preset": "fast", "generations": 4}


@pytest.fixture(autouse=True)
def short_sync_timeout(monkeypatch):
    monkeypatch.setattr(island, "SYNC_TIMEOUT_S", 60.0)


def make_artifact(workload="vgg16", seed=0, mask=0x15, fitness=1.25,
                  fingerprint="sha256:feed", backend="ga"):
    """A structurally valid artifact without running a search."""
    cost = ScheduleCost(energy_pj=10.0, cycles=5.0, dram_read_words=7,
                        dram_write_words=3, act_write_events=2, macs=100,
                        n_groups=4)
    return ScheduleArtifact(
        spec=SearchSpec(workload=workload, backend=backend, seed=seed,
                        backend_config=dict(FAST)),
        graph_fingerprint=fingerprint, n_edges=21, genome_mask=mask,
        best_fitness=fitness, baseline=cost, best=cost,
        history=[1.0, fitness], evaluations=9, offspring_evaluated=12)


# ---- keys, against the reference --------------------------------------------------

SPECS = [
    dict(workload="vgg16"),
    dict(workload="vgg16", seed=1),
    dict(workload="mobilenet_v3", backend="island",
         backend_config={"islands": 4, "preset": "fast", "generations": 60}),
    dict(workload="resnet50", accelerator="eyeriss@act+64"),
    dict(workload="mobilenet_v3@hw=160", objective="energy",
         backend="random", backend_config={"evaluations": 100},
         budget=50, patience=3),
    dict(workload="unet", workload_kwargs={"depth": 1}, telemetry=True),
    dict(workload="file:model.json"),
    dict(workload="ir:ir1:" + "ab" * 32, costmodel="tpu"),
]


@pytest.mark.parametrize("kw", SPECS)
@pytest.mark.parametrize("fp", ["ir1:" + "0" * 64, "sha256:feed"])
def test_keys_equal_the_references(kw, fp):
    mine, ref = SearchSpec(**kw), rs.SearchSpec(**kw)
    assert mine.to_dict() == ref.to_dict()
    assert spec_hash(mine) == rv.spec_hash(ref)
    assert artifact_key(fp, mine) == rv.artifact_key(fp, ref)


def _ref_store_with(tmp_path, specs):
    store = rv.ArtifactStore(str(tmp_path / "ref"))
    sched = rv.BatchScheduler(store, workers=1)
    for kw in specs:
        sched.submit(rs.SearchSpec(**kw))
    assert sched.run().stats["searched"] == len(specs)
    return store


SERVED = [dict(workload="vgg16", backend_config=dict(FAST)),
          dict(workload="unet", backend="island",
               backend_config={**FAST, "islands": 2, "migrate_every": 2})]


def test_reference_store_serves_the_port_with_zero_evaluations(tmp_path,
                                                               monkeypatch):
    ref_store = _ref_store_with(tmp_path, SERVED)
    import repro_torch.serve.scheduler as sched_mod

    def boom(*a, **k):
        raise AssertionError("a store hit must not build a SearchSession")

    monkeypatch.setattr(sched_mod, "SearchSession", boom)
    mine = BatchScheduler(ArtifactStore(ref_store.root), workers=1,
                          device="cpu")
    jobs = [mine.submit(SearchSpec(**kw)) for kw in SERVED]
    out = mine.run()
    assert out.stats == {"jobs": 2, "searched": 0, "cache_hits": 2,
                         "deduped_in_flight": 0, "failed": 0}
    assert mine.searches_run == 0
    assert sorted(job.key for job in jobs) == sorted(ref_store.keys())
    for job, kw in zip(jobs, SERVED):
        assert job.outcome == "cache_hit"
        assert job.key == rv.artifact_key(job.artifact.graph_fingerprint,
                                          rs.SearchSpec(**kw))
        assert job.artifact.backend_stats["pop_backend"] == "numpy"


def test_port_store_serves_the_reference_with_zero_evaluations(tmp_path,
                                                               monkeypatch):
    store = ArtifactStore(str(tmp_path / "mine"))
    sched = BatchScheduler(store, workers=1, device="cpu")
    for kw in SERVED:
        sched.submit(SearchSpec(**kw))
    assert sched.run().stats["searched"] == 2
    # the reference's own searches of the same specs, for the schedules
    fresh = _ref_store_with(tmp_path, SERVED)
    import repro.serve.scheduler as ref_sched_mod

    def boom(*a, **k):
        raise AssertionError("a store hit must not build a SearchSession")

    monkeypatch.setattr(ref_sched_mod, "SearchSession", boom)
    ref = rv.BatchScheduler(rv.ArtifactStore(store.root), workers=1)
    for kw in SERVED:
        ref.submit(rs.SearchSpec(**kw))
    out = ref.run()
    assert out.stats["cache_hits"] == 2 and out.stats["searched"] == 0
    assert sorted(j.key for j in out.jobs) == sorted(fresh.keys())
    for job in out.jobs:
        assert job.artifact.backend_stats["pop_backend"] == "torch"
        theirs = fresh.load_key(job.key)
        assert job.artifact.genome_mask == theirs.genome_mask
        assert job.artifact.history == theirs.history


# ---- the reference's store tests, on the port -------------------------------------

def test_spec_hash_canonical_across_json_round_trip():
    spec = SearchSpec(workload="vgg16", backend="island",
                      backend_config={"islands": 4, "migrate_every": 8})
    again = SearchSpec.from_json(spec.to_json())
    assert spec_hash(spec) == spec_hash(again)
    assert artifact_key("sha256:f", spec) == artifact_key("sha256:f", again)


def test_key_changes_with_spec_and_fingerprint():
    spec = SearchSpec(workload="vgg16")
    assert artifact_key("sha256:a", spec) != artifact_key("sha256:b", spec)
    assert artifact_key("sha256:a", spec) != \
        artifact_key("sha256:a", spec.replace(seed=1))


@settings(max_examples=25)
@given(mask=st.integers(min_value=0, max_value=(1 << 21) - 1),
       seed=st.integers(min_value=0, max_value=1 << 16),
       workload=st.sampled_from(["vgg16", "unet", "resnet50"]),
       backend=st.sampled_from(["ga", "island", "random"]))
def test_store_put_get_round_trip(mask, seed, workload, backend):
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="store-prop-")
    try:
        store = ArtifactStore(root)
        art = make_artifact(workload=workload, seed=seed, mask=mask,
                            backend=backend)
        key = store.put(art)
        got = store.get(art.graph_fingerprint, art.spec)
        assert got is not None
        assert got.to_dict() == art.to_dict()
        assert store.path_for(key).startswith(root)
        assert list(store.keys()) == [key]
        # the same object path in the reference's layout
        assert rv.ArtifactStore(root).path_for(key) == store.path_for(key)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def test_store_miss_and_counters(tmp_path):
    store = ArtifactStore(str(tmp_path))
    assert store.get("sha256:none", SearchSpec(workload="vgg16")) is None
    store.put(make_artifact())
    store.get("sha256:feed", make_artifact().spec)
    s = store.stats()
    assert (s["hits"], s["misses"], s["puts"], s["objects"]) == (1, 1, 1, 1)


def test_store_put_is_idempotent(tmp_path):
    store = ArtifactStore(str(tmp_path))
    art = make_artifact()
    assert store.put(art) == store.put(art)
    assert len(store) == 1


def test_store_rejects_corrupt_object(tmp_path):
    store = ArtifactStore(str(tmp_path))
    art = make_artifact()
    key = store.put(art)
    with open(store.path_for(key), "w") as f:
        f.write("{ not json")
    with pytest.raises(StoreError, match="corrupt"):
        store.get(art.graph_fingerprint, art.spec)


def test_store_rejects_key_content_mismatch(tmp_path):
    store = ArtifactStore(str(tmp_path))
    art = make_artifact()
    key = store.put(art)
    other = make_artifact(seed=99)
    wrong = store.path_for(artifact_key(other.graph_fingerprint, other.spec))
    os.makedirs(os.path.dirname(wrong), exist_ok=True)
    with open(store.path_for(key)) as src, open(wrong, "w") as dst:
        dst.write(src.read())
    with pytest.raises(StoreError, match="does not match its key"):
        store.get(other.graph_fingerprint, other.spec)


def test_store_version_gate(tmp_path):
    ArtifactStore(str(tmp_path))
    (tmp_path / "store.json").write_text(json.dumps({"store_version": 99}))
    with pytest.raises(StoreError, match="layout version"):
        ArtifactStore(str(tmp_path))


def test_store_requires_create_flag_for_new_root(tmp_path):
    with pytest.raises(StoreError, match="no store"):
        ArtifactStore(str(tmp_path / "absent"), create=False)


def _pre_pr3_dict():
    d = make_artifact().to_dict()
    del d["group_breakdowns"]
    del d["spec"]["costmodel"]
    return d


def test_pre_pr3_artifact_loads_with_warning(tmp_path):
    art = ScheduleArtifact.from_dict(_pre_pr3_dict())
    assert art.spec.costmodel == "default"
    assert art.group_breakdowns == []
    assert any("predates per-group cost breakdowns" in w
               for w in art.load_warnings)
    store = ArtifactStore(str(tmp_path))
    path = store.path_for(artifact_key(art.graph_fingerprint, art.spec))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(_pre_pr3_dict(), f)
    got = store.get(art.graph_fingerprint, art.spec)
    assert got is not None and got.load_warnings


def test_malformed_breakdown_rows_drop_not_crash():
    d = make_artifact().to_dict()
    d["group_breakdowns"] = [{"bogus": 1}]
    art = ScheduleArtifact.from_dict(d)
    assert art.group_breakdowns == []
    assert any("malformed group breakdown" in w for w in art.load_warnings)


@pytest.mark.parametrize("damage", ["missing_field", "missing_object"])
def test_damaged_cost_records_raise_value_error_and_cli_exits_2(damage,
                                                                tmp_path):
    from repro_torch.__main__ import main
    d = make_artifact().to_dict()
    if damage == "missing_field":
        del d["best"]["energy_pj"]
        match = "malformed ScheduleCost"
    else:
        del d["best"]
        match = "missing required field 'best'"
    with pytest.raises(ValueError, match=match):
        ScheduleArtifact.from_dict(d)
    path = tmp_path / "corrupt.json"
    path.write_text(json.dumps(d))
    assert main(["report", str(path)]) == 2


def test_unknown_cost_fields_warn_not_crash():
    d = make_artifact().to_dict()
    d["best"]["future_field"] = 1.0
    art = ScheduleArtifact.from_dict(d)
    assert art.best.energy_pj == 10.0
    assert any("unknown ScheduleCost fields" in w for w in art.load_warnings)


def test_cli_report_pre_pr3_artifact_warns_and_succeeds(tmp_path, capsys):
    from repro_torch.__main__ import main
    path = tmp_path / "old.json"
    path.write_text(json.dumps(_pre_pr3_dict()))
    assert main(["report", str(path)]) == 0
    err = capsys.readouterr().err
    assert "warning" in err and "predates" in err


def _hammer(args):
    root, worker = args
    store = ArtifactStore(root)
    for i in range(12):
        store.put(make_artifact(mask=i, seed=i, fitness=1.0 + worker))
    return worker


def test_concurrent_writers_never_tear_objects(tmp_path):
    root = str(tmp_path)
    ArtifactStore(root)
    ctx = multiprocessing.get_context("fork")
    with ctx.Pool(4) as pool:
        done = pool.map(_hammer, [(root, w) for w in range(4)])
    assert sorted(done) == [0, 1, 2, 3]
    store = ArtifactStore(root)
    keys = list(store.keys())
    assert len(keys) == 12
    for key in keys:
        art = store.load_key(key)
        assert art.genome_mask in range(12)
        assert art.best_fitness in (1.0, 2.0, 3.0, 4.0)


# ---- the reference's scheduler tests, on the port ---------------------------------

def test_scheduler_needs_a_device_or_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchScheduler(None)


def test_scheduler_dedups_and_caches(tmp_path):
    store = ArtifactStore(str(tmp_path))
    sched = BatchScheduler(store, workers=1, device="cpu")
    spec = SearchSpec(workload="vgg16", backend_config=dict(FAST))
    sched.submit(spec)
    sched.submit(SearchSpec.from_dict(spec.to_dict()))
    sched.submit(spec.replace(seed=1))
    out = sched.run()
    s = out.stats
    assert s["searched"] == 2 and s["cache_hits"] == 1
    assert s["deduped_in_flight"] == 1 and s["failed"] == 0
    assert sched.searches_run == 2
    assert out.jobs[1].key == out.jobs[0].key
    assert out.jobs[0].artifact.backend_stats["pop_backend"] == "torch"


def test_scheduler_resubmit_hits_store_with_zero_evaluations(tmp_path,
                                                            monkeypatch):
    store = ArtifactStore(str(tmp_path))
    spec = SearchSpec(workload="vgg16", backend_config=dict(FAST))
    first = BatchScheduler(store, workers=1, device="cpu")
    first.submit(spec)
    assert first.run().stats["searched"] == 1
    import repro_torch.serve.scheduler as sched_mod

    def boom(*a, **k):
        raise AssertionError("cache hit must not build a SearchSession")

    monkeypatch.setattr(sched_mod, "SearchSession", boom)
    again = BatchScheduler(store, workers=1, device="cpu")
    job = again.submit(SearchSpec.from_dict(spec.to_dict()))
    out = again.run()
    assert out.stats == {**out.stats, "searched": 0, "cache_hits": 1}
    assert again.searches_run == 0
    assert job.artifact.genome_mask >= 0


def test_scheduler_worker_pool_matches_inline(tmp_path):
    specs = [SearchSpec(workload="vgg16", backend_config=dict(FAST)),
             SearchSpec(workload="unet", backend_config=dict(FAST))]
    inline = BatchScheduler(ArtifactStore(str(tmp_path / "a")), workers=1,
                            device="cpu")
    pooled = BatchScheduler(ArtifactStore(str(tmp_path / "b")), workers=2,
                            device="cpu")
    for s in specs:
        inline.submit(s)
        pooled.submit(s)
    ja, jb = inline.run().jobs, pooled.run().jobs
    for a, b in zip(ja, jb):
        assert a.key == b.key
        assert a.artifact.genome_mask == b.artifact.genome_mask
        assert a.artifact.best_fitness == b.artifact.best_fitness


def test_scheduler_pool_runs_island_backend(tmp_path):
    """Island searches inside daemonic pool workers run their islands as
    threads (the evaluator's batch lock makes that safe) and give the
    inline result exactly."""
    store = ArtifactStore(str(tmp_path))
    sched = BatchScheduler(store, workers=2, device="cpu")
    isl = SearchSpec(workload="vgg16", backend="island",
                     backend_config={**FAST, "islands": 2,
                                     "migrate_every": 2})
    sched.submit(isl)
    sched.submit(SearchSpec(workload="unet", backend_config=dict(FAST)))
    out = sched.run()
    assert out.stats["failed"] == 0 and out.stats["searched"] == 2
    inline = BatchScheduler(ArtifactStore(str(tmp_path / "b")), workers=1,
                            device="cpu")
    job = inline.submit(SearchSpec.from_dict(isl.to_dict()))
    inline.run()
    assert job.artifact.genome_mask == out.jobs[0].artifact.genome_mask
    assert job.artifact.history == out.jobs[0].artifact.history


def test_scheduler_isolates_failing_jobs(tmp_path):
    store = ArtifactStore(str(tmp_path))
    sched = BatchScheduler(store, workers=1, device="cpu")
    sched.submit(SearchSpec(workload="no_such_net"))
    ok = sched.submit(SearchSpec(workload="vgg16",
                                 backend_config=dict(FAST)))
    out = sched.run()
    assert out.stats["failed"] == 1 and out.stats["searched"] == 1
    assert out.jobs[0].status == "failed" and "no_such_net" in \
        out.jobs[0].error
    assert ok.status == "done"


def test_scheduler_isolates_corrupt_store_objects(tmp_path):
    store = ArtifactStore(str(tmp_path))
    spec = SearchSpec(workload="vgg16", backend_config=dict(FAST))
    seeder = BatchScheduler(store, workers=1, device="cpu")
    seeder.submit(spec)
    key = seeder.run().jobs[0].key
    with open(store.path_for(key), "w") as f:
        f.write("{ torn")
    sched = BatchScheduler(store, workers=1, device="cpu")
    bad = sched.submit(SearchSpec.from_dict(spec.to_dict()))
    good = sched.submit(SearchSpec(workload="unet",
                                   backend_config=dict(FAST)))
    out = sched.run()
    assert bad.status == "failed" and "corrupt" in bad.error
    assert good.status == "done"
    assert out.stats["failed"] == 1 and out.stats["searched"] == 1


def test_scheduler_records_jobs_dedup_and_store_hits(tmp_path):
    """tests/test_obs_search.py's serve case: the collector sees jobs, the
    in-flight dedup and the store hits, as the reference's does."""
    from repro_torch.obs import TelemetryCollector, Tracer
    from repro_torch.obs.traceview import read_trace
    p = tmp_path / "serve.jsonl"
    store = ArtifactStore(str(tmp_path / "store"))
    spec = SearchSpec(workload="vgg16", backend="ga",
                      backend_config={"preset": "fast", "generations": 4})
    col = TelemetryCollector(tracer=Tracer(str(p)))
    sched = BatchScheduler(store, workers=1, obs=col, device="cpu")
    sched.submit(spec)
    sched.submit(SearchSpec.from_dict(spec.to_dict()))
    out = sched.run()
    assert out.stats["searched"] == 1 and out.stats["cache_hits"] == 1
    col2 = TelemetryCollector(tracer=Tracer(str(p)))
    again = BatchScheduler(store, workers=1, obs=col2, device="cpu")
    again.submit(SearchSpec.from_dict(spec.to_dict()))
    again.run()
    col.close()
    col2.close()
    c1 = col.registry.snapshot()["counters"]
    assert c1["serve.jobs{outcome=searched}"] == 1
    assert c1["serve.jobs{outcome=cache_hit}"] == 1
    assert c1["serve.deduped_in_flight"] == 1
    assert c1["serve.store_misses"] == 1 and c1["serve.store_hits"] == 0
    assert col2.registry.snapshot()["counters"]["serve.store_hits"] == 1
    rep = read_trace(str(p))
    assert rep.valid
    assert rep.point_counts["serve.job"] == 3
    assert rep.span_counts["serve.batch"] == 2


def test_load_requests_reads_both_shapes(tmp_path):
    from repro.serve.scheduler import load_requests as ref_load
    from repro_torch.serve.scheduler import load_requests
    jobs = [{"workload": "vgg16", "backend_config": FAST},
            {"workload": "unet", "seed": 2}]
    for payload in (jobs, {"jobs": jobs}):
        path = tmp_path / "jobs.json"
        path.write_text(json.dumps(payload))
        assert [s.to_dict() for s in load_requests(str(path))] == \
            [s.to_dict() for s in ref_load(str(path))]
    path.write_text(json.dumps({"nope": 1}))
    with pytest.raises(ValueError, match="expected a JSON list"):
        load_requests(str(path))
