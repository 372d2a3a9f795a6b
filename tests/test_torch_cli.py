"""The port's CLI (``python -m repro_torch``) against the reference's
(``python -m repro``), on the CPU (``--device cpu``).

Each subcommand the port has runs with the same arguments in both packages
and must print the same output, with the clocks left out (search wall
seconds, span durations, the engine's throughput), the engine's name
(``torch`` here, ``numpy`` in the reference) and the command's own name:
``search`` (island backend, telemetry and a trace) then ``report`` (with
``--telemetry``, ``--schedule``, ``--json``), ``trace``, ``serve`` (the
README's jobs file: an island job twice, deduplicated, and a second
workload), ``submit`` (served from the store), ``verify`` of artifacts and
of the store, ``list``, ``analyze``, ``store gc`` and ``lint``.  One round
runs as subprocesses, as a user runs it, and so does the daemon with its
``jobs`` client (submit, list, status, wait, cancel) and a restart that
replays the journal; the rest call ``main`` in-process, as the reference's
tests do.  ``--costmodel tpu`` searches and analyses print the reference's
output too, and without a card the default device is an error (exit 2),
never a silent CPU run.
"""
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

import repro_torch.search.island as island
from repro.__main__ import main as ref_main
from repro_torch.__main__ import main

ROOT = Path(__file__).resolve().parents[1]
FAST = {"preset": "fast", "generations": 6}
SEARCH = ["search", "--workload", "mobilenet_v3", "--backend", "island",
          "--backend-config", json.dumps({"islands": 2, "migrate_every": 3}),
          "--preset", "fast", "--generations", "8", "--seed", "0"]


@pytest.fixture(autouse=True)
def short_sync_timeout(monkeypatch):
    monkeypatch.setattr(island, "SYNC_TIMEOUT_S", 60.0)
    monkeypatch.delenv("REPRO_TRACE", raising=False)


def norm(text: str) -> str:
    """Output without clocks, the engine's name and the command's name."""
    text = text.replace("python -m repro_torch", "repro")
    text = re.sub(r"\d+\.\d+s\b", "<s>", text)
    text = re.sub(r"batch_evals_per_sec \d+", "batch_evals_per_sec <n>",
                  text)
    text = re.sub(r"engine (torch|numpy)\b", "engine <engine>", text)
    text = re.sub(r"\(pid \d+, id \d+\)", "(pid, id)", text)
    return text


@pytest.fixture
def dirs(tmp_path, monkeypatch):
    """Each package works in its own directory, so the same relative paths
    (artifacts, stores, traces) name each package's own files and print
    alike."""
    port, ref = tmp_path / "port", tmp_path / "ref"
    port.mkdir()
    ref.mkdir()
    return monkeypatch, port, ref


def run_both(capsys, dirs, argv_port, argv_ref=None):
    """(rc, stdout) of the port's main, in its directory, and of the
    reference's, in its own."""
    monkeypatch, port, ref = dirs
    monkeypatch.chdir(port)
    rc = main(argv_port)
    out = capsys.readouterr().out
    monkeypatch.chdir(ref)
    ref_rc = ref_main(argv_ref if argv_ref is not None else
                      [a for a in argv_port if a not in ("--device", "cpu")])
    ref_out = capsys.readouterr().out
    return (rc, out), (ref_rc, ref_out)


def same(capsys, dirs, argv_port, argv_ref=None, rc=0):
    (a_rc, a), (b_rc, b) = run_both(capsys, dirs, argv_port, argv_ref)
    assert (a_rc, norm(a)) == (b_rc, norm(b))
    assert a_rc == rc
    return a


# ---- as a user runs it ------------------------------------------------------------

def _cli(package, *argv, cwd):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    env.pop("REPRO_TRACE", None)
    return subprocess.run([sys.executable, "-m", package, *argv], cwd=cwd,
                          capture_output=True, text=True, env=env,
                          timeout=300)


def test_subprocess_search_trace_report_round_trip(tmp_path):
    outs = {}
    for package, extra in (("repro_torch", ["--device", "cpu"]),
                           ("repro", [])):
        d = tmp_path / package
        d.mkdir()
        r = _cli(package, *SEARCH, "--telemetry", "--trace", "run.jsonl",
                 "--out", "a.json", *extra, cwd=d)
        assert r.returncode == 0, r.stderr
        t = _cli(package, "trace", "run.jsonl", "--json", cwd=d)
        assert t.returncode == 0, t.stderr
        rep = _cli(package, "report", "a.json", "--telemetry", cwd=d)
        assert rep.returncode == 0, rep.stderr
        outs[package] = (r.stdout, json.loads(t.stdout), rep.stdout,
                         json.loads((d / "a.json").read_text()))
    mine, ref = outs["repro_torch"], outs["repro"]
    assert norm(mine[0]) == norm(ref[0])
    for key in ("valid", "n_events", "n_spans", "n_points", "span_counts",
                "point_counts"):
        assert mine[1][key] == ref[1][key], key
    assert mine[1]["span_counts"]["generation"] == \
        mine[3]["telemetry"]["steps"]
    assert norm(mine[2]) == norm(ref[2])
    assert "all checks passed" in mine[2] and "certificate  :" in mine[2]
    assert mine[3]["backend_stats"]["pop_backend"] == "torch"


def test_default_device_needs_a_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    r = _cli("repro_torch", "search", "--workload", "vgg16", "--out",
             "a.json", cwd=tmp_path)
    assert r.returncode == 2
    assert "no CUDA device" in r.stderr and "--device cpu" in r.stderr
    assert not (tmp_path / "a.json").exists()


# ---- in-process, against the reference --------------------------------------------

@pytest.fixture
def searched(dirs, capsys):
    """The same island search through both CLIs, each writing ``a.json`` in
    its directory."""
    same(capsys, dirs, SEARCH + ["--telemetry", "--out", "a.json",
                                 "--device", "cpu"])
    return dirs


@pytest.mark.parametrize("flags", [[], ["--schedule"], ["--telemetry"],
                                   ["--history", "--breakdown"]],
                         ids=["plain", "schedule", "telemetry", "history"])
def test_report_prints_the_references(searched, capsys, flags):
    out = same(capsys, searched, ["report", "a.json", *flags])
    assert "verification : all checks passed" in out


def test_report_json_equals_the_references(searched, capsys):
    (rc, out), (ref_rc, ref_out) = run_both(
        capsys, searched, ["report", "a.json", "--json", "--telemetry"])
    assert rc == ref_rc == 0
    mine, ref = json.loads(out), json.loads(ref_out)
    # the embedded summary is held to the reference's in test_torch_obs.py
    assert mine.pop("telemetry")["steps"] == ref.pop("telemetry")["steps"]
    assert mine == ref
    assert mine["verified"] and mine["certificate"]["gap_vs_graph"] >= 0


def _jobs(path):
    # the README's jobs file (islands and generations cut to test size)
    isl = {"workload": "mobilenet_v3", "backend": "island",
           "backend_config": {"islands": 2, "preset": "fast",
                              "generations": 8}}
    path.write_text(json.dumps(
        [isl, isl, {"workload": "resnet50", "accelerator": "eyeriss@act+64",
                    "backend_config": FAST}]))
    return str(path)


@pytest.mark.parametrize("workers", ["1", "2"])
def test_serve_submit_verify_store_print_the_references(dirs, capsys,
                                                        workers):
    _, port, ref = dirs
    for d in (port, ref):
        _jobs(d / "jobs.json")
    # the reference drains inline: its pool workers run island jobs as
    # threads, which race in its engine (ROADMAP C; a wrong schedule or a
    # failed job now and then), while the port's pool gives the inline
    # result exactly
    out = same(capsys, dirs, ["serve", "--store", "S", "--requests",
                              "jobs.json", "--workers", workers,
                              "--device", "cpu"],
               ["serve", "--store", "S", "--requests", "jobs.json"])
    assert "stats: 3 jobs — 2 searched, 1 cache hits (1 deduped " \
           "in-flight), 0 failed; store holds 2 schedules" in out
    # the same store keys (content addresses), so the stores agree
    keys = sorted(p.name for p in (port / "S" / "objects").rglob("*.json"))
    assert keys == sorted(
        p.name for p in (ref / "S" / "objects").rglob("*.json"))
    for p in (port / "S" / "objects").rglob("*.json"):
        art = json.loads(p.read_text())
        assert art["backend_stats"]["pop_backend"] == "torch"
    # a resubmitted batch is all store hits, then one submit of job 0
    out = same(capsys, dirs, ["serve", "--store", "S", "--requests",
                              "jobs.json", "--json", "--device", "cpu"])
    assert json.loads(out)["stats"]["cache_hits"] == 3
    out = same(capsys, dirs, [
        "submit", "--store", "S", "--workload", "mobilenet_v3", "--backend",
        "island", "--backend-config", json.dumps({"islands": 2}),
        "--preset", "fast", "--generations", "8", "--device", "cpu"])
    assert out.startswith("served from store  key=")
    out = same(capsys, dirs, ["verify", "--store", "S"])
    assert "2 artifact(s): 2 verified, 0 failed" in out
    same(capsys, dirs, ["list", "--store", "S"])
    # each package's verifier reads the other's store
    assert main(["verify", "--store", str(ref / "S")]) == 0
    assert ref_main(["verify", "--store", str(port / "S")]) == 0


def test_verify_exit_codes_match_the_references(searched, capsys):
    _, port, ref = searched
    for d in (port, ref):
        art = json.loads((d / "a.json").read_text())
        art["genome_mask"] = hex(int(art["genome_mask"], 16) ^ 1)
        (d / "bad.json").write_text(json.dumps(art))
    out = same(capsys, searched, ["verify", "a.json"])
    assert "1 artifact(s): 1 verified, 0 failed" in out
    out = same(capsys, searched, ["verify", "bad.json"], rc=1)
    assert "FAILED" in out and "fused-edges" in out
    same(capsys, searched, ["verify"], rc=2)


def test_serve_failures_set_the_exit_code(dirs, capsys):
    for d in dirs[1:]:
        (d / "jobs.json").write_text(json.dumps([{"workload":
                                                  "no_such_net"}]))
    same(capsys, dirs, ["serve", "--store", "S", "--requests", "jobs.json",
                        "--device", "cpu"], rc=1)
    same(capsys, dirs, ["serve", "--store", "S", "--requests",
                        "missing.json", "--device", "cpu"], rc=2)


def test_list_shows_the_ported_registries(capsys):
    assert main(["list"]) == 0
    out = capsys.readouterr().out
    assert "island" in out and "migrate_every" in out
    assert "crossover_rate" in out
    assert "costmodels: default, tpu\n" in out
    assert main(["list", "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert sorted(payload["backends"]) == [
        "exhaustive", "ga", "hill_climb", "island", "random"]


@pytest.mark.parametrize("argv", [
    ["search", "--workload", "vgg16", "--costmodel", "tpu"],
    ["search", "--workload", "vgg16", "--costmodel", "tpu", "--spacemap"],
    ["search", "--workload", "resnet50", "--costmodel", "tpu", "--backend",
     "random"],
    ["analyze", "mobilenet_v3", "--costmodel", "tpu"],
    ["analyze", "vgg16", "--costmodel", "tpu", "--json"],
    ["search", "--workload", "unet", "--costmodel", "tpu", "--backend",
     "exhaustive", "--spacemap"],
])
def test_unported_subcommands_exit_2_naming_the_roadmap(argv, capsys, dirs):
    """The ``tpu`` cost model is ported: each command that runs it (these
    once exited 2 naming ROADMAP A2) now prints what ``python -m repro``
    prints, clocks left out, with its exit code (unet's exhaustive space
    is over the limit in both: 2), and writes the reference's
    artifact."""
    port = argv + (["--device", "cpu"] if argv[0] != "analyze" else [])
    (rc, out), (ref_rc, ref_out) = run_both(capsys, dirs, port, argv)
    assert (rc, norm(out)) == (ref_rc, norm(ref_out))
    assert rc == (2 if "unet" in argv else 0)
    if argv[0] == "search" and rc == 0:
        _, pdir, rdir = dirs
        mine, ref = (json.loads((d / "artifact.json").read_text())
                     for d in (pdir, rdir))
        assert mine["spec"]["costmodel"] == "tpu"
        for key in ("genome_mask", "best_fitness", "evaluations",
                    "history", "group_breakdowns", "spacemap"):
            assert mine.get(key) == ref.get(key), key


def test_search_refuses_spacemap(tmp_path, capsys):
    """``--spacemap`` searches (vgg16's factorized space, as the
    reference's), under the ``tpu`` capacity rule too (once refused): the
    reference's genome, and an artifact that verifies."""
    out = tmp_path / "a.json"
    assert main(["search", "--workload", "vgg16", "--spacemap", "--backend",
                 "exhaustive", "--out", str(out), "--device", "cpu"]) == 0
    capsys.readouterr()
    art = json.loads(out.read_text())
    assert art["spacemap"]["forced_off"] == [1, 4, 7, 8, 11, 12, 15, 16]
    assert int(art["genome_mask"], 16) == 0x1A4225
    assert main(["verify", str(out)]) == 0
    assert "[ok  ] spacemap:" in capsys.readouterr().out
    from repro.search import search as ref_search
    tpu = tmp_path / "b.json"
    assert main(["search", "--workload", "vgg16", "--spacemap", "--costmodel",
                 "tpu", "--preset", "fast", "--generations", "4", "--out",
                 str(tpu), "--device", "cpu"]) == 0
    capsys.readouterr()
    ref = ref_search("vgg16", "simba", costmodel="tpu", spacemap=True,
                     backend="ga", backend_config={"preset": "fast",
                                                   "generations": 4})
    art = json.loads(tpu.read_text())
    assert int(art["genome_mask"], 16) == ref.genome_mask
    assert art["spacemap"] == json.loads(ref.to_json())["spacemap"]
    assert main(["verify", str(tpu)]) == 0
    assert "[ok  ] spacemap:" in capsys.readouterr().out


# ---- the subcommands of this slice -------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["analyze", "mobilenet_v3"],
    ["analyze", "vgg16", "--accel", "eyeriss@act+64", "--json"],
    ["analyze", "resnet50", "--costmodel", "nosuchmodel"],
])
def test_analyze_prints_the_references(argv, dirs, capsys):
    same(capsys, dirs, argv)


def test_store_gc_prints_the_references(dirs, capsys):
    _, port, ref = dirs
    for d in (port, ref):
        _jobs(d / "jobs.json")
    same(capsys, dirs, ["serve", "--store", "S", "--requests", "jobs.json",
                        "--device", "cpu"],
         ["serve", "--store", "S", "--requests", "jobs.json"])
    for d in (port, ref):                 # the same access order in both
        for i, p in enumerate(sorted((d / "S" / "objects").rglob("*.json"))):
            os.utime(p, (1000.0 + i, 1000.0 + i))
    # the same keys go; the sizes differ by the artifacts' clock digits
    for argv in (["store", "gc", "--store", "S", "--max-objects", "1",
                  "--dry-run", "--json"],
                 ["store", "gc", "--store", "S", "--max-bytes", "1",
                  "--dry-run"],
                 ["store", "gc", "--store", "S", "--max-objects", "1"]):
        (rc, out), (ref_rc, ref_out) = run_both(capsys, dirs, argv)
        assert rc == ref_rc == 0
        if "--json" in argv:
            mine, ref = json.loads(out), json.loads(ref_out)
            assert mine["evicted"] and mine["evicted"] == ref["evicted"]
            for k in ("bytes_total", "evicted_bytes", "bytes_after"):
                assert abs(mine.pop(k) - ref.pop(k)) <= 8, k
            assert mine == ref
        else:
            assert re.sub(r"\d+ bytes", "<n> bytes", out) == \
                re.sub(r"\d+ bytes", "<n> bytes", ref_out)
    assert len(list((port / "S" / "objects").rglob("*.json"))) == 1
    same(capsys, dirs, ["store", "gc", "--store", "missing"], rc=2)


def _daemon(store, cwd, *extra):
    """``python -m repro_torch daemon`` on a free port of 127.0.0.1, on the
    CPU; returns (process, base URL) once it listens."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch", "daemon", "--store", store,
         "--port", "0", "--device", "cpu", *extra], cwd=cwd, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for line in proc.stdout:
        m = re.search(r"listening on (http://\S+)", line)
        if m:
            return proc, m.group(1)
    raise AssertionError(f"daemon did not start: rc {proc.wait()}")


def _stop(proc) -> None:
    proc.terminate()
    try:
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _http(method, url, payload=None):
    import urllib.request
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.load(r)


def test_daemon_and_jobs_round_trip_in_subprocesses(tmp_path):
    """The daemon and its client as a user runs them: a job left queued by
    a daemon with no workers is replayed by a restart on the same store;
    ``jobs submit --wait`` gives the reference's artifact; a long job is
    cancelled while running (``jobs cancel``, ``jobs wait``); ``jobs
    list``."""
    from repro.search import search as ref_search
    from repro_torch.search import ScheduleArtifact, SearchSpec
    proc, base = _daemon("S", tmp_path, "--workers", "0")
    try:
        queued = _http("POST", f"{base}/jobs", {"spec": SearchSpec(
            workload="vgg16", seed=3,
            backend_config={"preset": "fast", "generations": 4}
        ).to_dict()})
        assert queued["state"] == "queued"
    finally:
        _stop(proc)
    proc, base = _daemon("S", tmp_path, "--workers", "1")
    try:
        r = _cli("repro_torch", "jobs", "--daemon", base, "submit",
                 "--workload", "mobilenet_v3", "--preset", "fast",
                 "--generations", "6", "--seed", "2", "--wait", "--json",
                 cwd=tmp_path)
        assert r.returncode == 0, r.stderr
        job = json.loads(r.stdout)
        assert job["state"] == "done" and job["outcome"] == "searched"
        assert job["id"] == queued["id"] + 1           # ids go on
        replayed = _http("GET", f"{base}/jobs/{queued['id']}")
        assert replayed["outcome"] == "searched"       # ran before job
        long = _http("POST", f"{base}/jobs", {"spec": SearchSpec(
            workload="unet", backend_config={"preset": "fast",
                                             "generations": 100000}
        ).to_dict()})
        deadline = time.monotonic() + 60
        while _http("GET", f"{base}/jobs/{long['id']}")["state"] != \
                "running":
            assert time.monotonic() < deadline
            time.sleep(0.05)
        c = _cli("repro_torch", "jobs", "--daemon", base, "cancel",
                 str(long["id"]), cwd=tmp_path)
        assert c.returncode == 0
        assert c.stdout.startswith(f"job {long['id']}: cancel")
        w = _cli("repro_torch", "jobs", "--daemon", base, "wait",
                 str(long["id"]), "--json", cwd=tmp_path)
        assert json.loads(w.stdout)["state"] == "cancelled"
        listed = _cli("repro_torch", "jobs", "--daemon", base, "list",
                      cwd=tmp_path)
        assert listed.stdout.strip().endswith("3 job(s)")
    finally:
        _stop(proc)
    art = ScheduleArtifact.load(
        str(tmp_path / "S" / "objects" / job["key"][:2] /
            f"{job['key']}.json"))
    ref = ref_search("mobilenet_v3", seed=2,
                     backend_config={"preset": "fast", "generations": 6})
    assert (art.genome_mask, art.best_fitness, art.evaluations) == \
        (ref.genome_mask, ref.best_fitness, ref.evaluations)


def test_lint_json_on_a_tree_with_findings(tmp_path, capsys):
    core = tmp_path / "src" / "repro_torch" / "core"
    core.mkdir(parents=True)
    (core / "m.py").write_text("import time\nT = time.time()\n")
    assert main(["lint", "--root", str(tmp_path), "--json"]) == 1
    found = json.loads(capsys.readouterr().out)
    assert [(f["path"], f["rule"], f["symbol"]) for f in found] == [
        ("src/repro_torch/core/m.py", "wall-clock", "time.time")]
