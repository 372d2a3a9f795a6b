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
of the store, and ``list``.  One round runs as subprocesses, as a user runs
it; the rest call ``main`` in-process, as the reference's tests do.  The
subcommands not ported yet exit 2 with a message naming the ROADMAP item,
and without a card the default device is an error (exit 2), never a silent
CPU run.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

import repro_torch.search.island as island
from repro.__main__ import main as ref_main
from repro_torch.__main__ import UNPORTED
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
    assert "costmodels: default\n" in out          # the tpu one: not ported
    assert main(["list", "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert sorted(payload["backends"]) == [
        "exhaustive", "ga", "hill_climb", "island", "random"]


@pytest.mark.parametrize("argv", [
    ["daemon", "--store", "S", "--port", "0"],
    ["jobs", "list"],
    ["store", "gc", "--store", "S", "--max-objects", "1"],
    ["analyze", "mobilenet_v3"],
    ["lint"],
    ["export", "--workload", "vgg16"],
])
def test_unported_subcommands_exit_2_naming_the_roadmap(argv, capsys,
                                                        tmp_path,
                                                        monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert main(argv) == 2
    err = capsys.readouterr().err
    assert f"`{argv[0]}` is not ported to repro_torch yet" in err
    assert "ROADMAP A2" in err and argv[0] in UNPORTED
    assert not (tmp_path / "S").exists()


def test_search_refuses_spacemap(tmp_path, capsys):
    assert main(["search", "--workload", "vgg16", "--spacemap", "--out",
                 str(tmp_path / "a.json"), "--device", "cpu"]) == 2
    assert "spacemap=True) is not ported" in capsys.readouterr().err
