"""The port's CLI (``python -m repro_torch``), a copy of ``repro``'s:
run searches, serve batches, inspect and verify artifacts, list
registries, aggregate traces.

    python -m repro_torch search --workload mobilenet_v3 --accel simba \\
        --backend island --backend-config '{"islands": 4}' --out a.json
    python -m repro_torch submit --store schedules/ --workload mobilenet_v3
    python -m repro_torch serve --store schedules/ --requests jobs.json \\
        --workers 2
    python -m repro_torch report a.json [--schedule] [--telemetry] [--json]
    python -m repro_torch verify a.json | ... verify --store schedules/
    python -m repro_torch trace trace.jsonl [--top 10] [--json]
    python -m repro_torch list [--json] [--store schedules/]

Every subcommand takes the reference's flags.  ``search``, ``submit`` and
``serve`` also take ``--device``: by default every search's label pass
runs on the card (and the command fails without one); ``--device cpu``
runs the plain PyTorch version.  ``daemon``, ``jobs``, ``store gc``,
``analyze``, ``lint`` and ``export`` are not ported yet: each exits 2 with
a message naming the ROADMAP item.  Nothing runs at import.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional


def _add_spec_args(p) -> None:
    """Arguments that assemble one SearchSpec (shared by search/submit)."""
    p.add_argument("--workload", required=True,
                   help="workload spec: a registered name (see `repro "
                        "list`), name@key=value,... params, or "
                        "file:model.json GraphIR")
    p.add_argument("--workload-kwargs", default="{}", metavar="JSON",
                   help="builder kwargs, e.g. '{\"hw\": 128}' "
                        "(equivalent to @-params in --workload)")
    p.add_argument("--accelerator", "--accel", dest="accelerator",
                   default="simba",
                   help="accelerator (repro_torch.hw catalog name), optionally "
                        "repartitioned (e.g. eyeriss@act+64)")
    p.add_argument("--objective", default="edp",
                   help="registered objective (edp|energy|cycles|dram|...)")
    p.add_argument("--backend", default="ga",
                   help="search backend (ga|island|random|hill_climb|"
                        "exhaustive|...)")
    p.add_argument("--costmodel", default="default",
                   help="cost backend scoring the schedules (default|tpu|...)")
    p.add_argument("--backend-config", default="{}", metavar="JSON",
                   help="backend options, e.g. '{\"islands\": 4}' "
                        "(knobs: `repro list`)")
    p.add_argument("--preset", choices=("paper", "fast"), default=None,
                   help="ga preset (paper: P=100 G=500; fast: CPU-friendly)")
    p.add_argument("--generations", type=int, default=None,
                   help="ga generations override")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--budget", type=int, default=None,
                   help="stop after this many offspring evaluations")
    p.add_argument("--patience", type=int, default=None,
                   help="stop after N backend steps without improvement "
                        "(ga: a step is one generation; island: one sync "
                        "barrier, i.e. up to ~10 generations; "
                        "random/exhaustive: one scoring chunk)")
    p.add_argument("--spacemap", action="store_true",
                   help="the reference's static fusion-space analysis; not "
                        "ported yet (refused, exit 2)")
    p.add_argument("--telemetry", action="store_true",
                   help="record per-generation convergence telemetry and "
                        "embed the summary in the artifact (repro report "
                        "--telemetry renders it); never changes the search "
                        "result")
    _add_device_arg(p)


def _add_device_arg(p) -> None:
    p.add_argument("--device", default=None,
                   help="where the population engine's label pass runs: "
                        "cuda (the default, the CUDA kernel; fails without "
                        "a card) or cpu (its plain PyTorch version)")


def _spec_from_args(args):
    """Build the SearchSpec an invocation of _add_spec_args describes."""
    from repro_torch.search import SearchSpec

    backend_config = json.loads(args.backend_config)
    if args.preset is not None:
        backend_config.setdefault("preset", args.preset)
    if args.generations is not None:
        backend_config.setdefault("generations", args.generations)
    return SearchSpec(
        workload=args.workload, accelerator=args.accelerator,
        objective=args.objective, backend=args.backend,
        costmodel=args.costmodel, backend_config=backend_config,
        workload_kwargs=json.loads(args.workload_kwargs),
        seed=args.seed, budget=args.budget, patience=args.patience,
        spacemap=args.spacemap, telemetry=args.telemetry)


def _add_search_parser(sub) -> None:
    p = sub.add_parser(
        "search", help="run a schedule search and write a JSON artifact")
    _add_spec_args(p)
    p.add_argument("--out", default="artifact.json",
                   help="artifact path (default: artifact.json)")
    p.add_argument("--progress", type=int, default=0, metavar="N",
                   help="print progress every N backend steps")
    p.add_argument("--embed-ir", action="store_true",
                   help="embed the workload's GraphIR in the artifact "
                        "(self-contained report/rebind; automatic for "
                        "file: workloads)")
    p.add_argument("--trace", default=None, metavar="TRACE_JSONL",
                   help="stream span events to this JSONL file (implies "
                        "--telemetry; inspect with `repro trace`; "
                        "REPRO_TRACE=path is the env equivalent)")


def _add_submit_parser(sub) -> None:
    p = sub.add_parser(
        "submit", help="resolve one search request against a schedule "
                       "store: serve a stored artifact, or search and "
                       "store the result")
    _add_spec_args(p)
    p.add_argument("--store", required=True,
                   help="ArtifactStore directory (created if absent)")
    p.add_argument("--out", default=None,
                   help="also write the artifact JSON to this path")


def _add_serve_parser(sub) -> None:
    p = sub.add_parser(
        "serve", help="drain a batch of search requests against a schedule "
                      "store (dedup + cache + parallel search)")
    p.add_argument("--requests", required=True, metavar="JOBS_JSON",
                   help="JSON list of SearchSpec objects "
                        "(or {\"jobs\": [...]})")
    p.add_argument("--store", required=True,
                   help="ArtifactStore directory (created if absent)")
    p.add_argument("--workers", type=int, default=1,
                   help="parallel search processes for cache misses "
                        "(default 1 = inline)")
    p.add_argument("--json", action="store_true",
                   help="emit per-job outcomes + stats as JSON")
    _add_device_arg(p)


#: the reference's subcommands the port does not have yet, with the ROADMAP
#: item that ports them
UNPORTED = {
    "daemon": "the always-on daemon (ROADMAP A2: daemon + job queue + "
              "warm start + store gc)",
    "jobs": "the daemon's job client (ROADMAP A2: daemon + job queue + "
            "warm start + store gc)",
    "store": "store gc (ROADMAP A2: daemon + job queue + warm start + "
             "store gc)",
    "analyze": "the static fusion-space analysis (ROADMAP A2: spacemap)",
    "lint": "the determinism lint (ROADMAP A2: analysis/lint.py)",
    "export": "the GraphIR export/import pipeline (ROADMAP A2: file: "
              "workloads, ir/passes.py)",
}


def _add_unported_parsers(sub) -> None:
    for name, what in UNPORTED.items():
        sub.add_parser(name, help=f"not ported yet: {what}",
                       add_help=False)


def _add_report_parser(sub) -> None:
    p = sub.add_parser(
        "report", help="summarize a search artifact (no re-search)")
    p.add_argument("artifact", help="path to a ScheduleArtifact JSON")
    p.add_argument("--schedule", action="store_true",
                   help="rebuild the workload and render the fused schedule "
                        "(paper Fig. 9 analogue)")
    p.add_argument("--breakdown", action="store_true",
                   help="show the per-group cost breakdown table in full "
                        "(a top-10 view prints by default)")
    p.add_argument("--history", action="store_true",
                   help="print the convergence history trace")
    p.add_argument("--telemetry", action="store_true",
                   help="render the embedded telemetry summary "
                        "(convergence curve + cache stats; requires a "
                        "search run with --telemetry/--trace)")
    p.add_argument("--json", action="store_true",
                   help="emit the summary as JSON")


def _add_verify_parser(sub) -> None:
    p = sub.add_parser(
        "verify", help="independently re-check artifacts: groups, "
                       "schedulability, footprints, cost consistency, and "
                       "the DRAM-traffic lower-bound certificate "
                       "(repro_torch.analysis)")
    p.add_argument("artifacts", nargs="*", metavar="ARTIFACT",
                   help="ScheduleArtifact JSON paths")
    p.add_argument("--store", default=None, metavar="DIR",
                   help="verify every object in an ArtifactStore (also "
                        "checks each object's content address)")
    p.add_argument("--json", action="store_true",
                   help="emit per-artifact check results as JSON")


def _add_trace_parser(sub) -> None:
    p = sub.add_parser(
        "trace", help="aggregate a telemetry JSONL trace: validate every "
                      "event against the schema, render the span tree, "
                      "top-k slowest spans, and metric rollups "
                      "(repro_torch.obs.traceview)")
    p.add_argument("trace", metavar="TRACE_JSONL",
                   help="trace file written via --trace / REPRO_TRACE")
    p.add_argument("--top", type=int, default=10,
                   help="slowest spans to list (default 10)")
    p.add_argument("--json", action="store_true",
                   help="emit the aggregate as JSON")


def _env_collector():
    """A TelemetryCollector streaming to ``$REPRO_TRACE``, or None when the
    env var is unset — the CLI's obs hook for verify/serve paths (searches
    build their own collector inside SearchSession)."""
    from repro_torch.obs import TelemetryCollector
    return TelemetryCollector.from_env()


def _summary_line(artifact) -> str:
    s = artifact.summary()
    return (f"{s['workload']} on {s['accelerator']} [{s['backend']}, "
            f"costmodel {s['costmodel']}, seed {s['seed']}]: "
            f"energy x{s['energy_x']}  {artifact.spec.objective} best "
            f"{artifact.best_fitness:.4f}  edp x{s['edp_x']}  "
            f"groups {s['groups']}  "
            f"({artifact.evaluations} evals, {artifact.wall_s:.1f}s)")


def _cmd_search(args) -> int:
    from repro_torch.search import SearchSession

    spec = _spec_from_args(args)
    every = args.progress

    def progress(p) -> None:
        if every and p.step % every == 0:
            print(f"  step {p.step:>5}  best {p.best_fitness:.4f}  "
                  f"evals {p.evaluations}", file=sys.stderr)

    session = SearchSession(spec, embed_ir=True if args.embed_ir else None,
                            trace_path=args.trace, device=args.device)
    artifact = session.run(progress=progress if every else None)
    artifact.save(args.out)
    print(_summary_line(artifact))
    print(f"wrote {args.out}")
    if args.trace:
        print(f"trace: {args.trace} (inspect with `python -m repro_torch "
              f"trace {args.trace}`)")
    return 0


def _cmd_submit(args) -> int:
    from repro_torch.serve import ArtifactStore, BatchScheduler

    store = ArtifactStore(args.store)
    col = _env_collector()
    try:
        sched = BatchScheduler(store, workers=1, obs=col,
                               device=args.device)
        sched.submit(_spec_from_args(args))
        job = sched.run().jobs[0]
    finally:
        if col is not None:
            col.close()
    if job.status == "failed":
        print(f"error: {job.error}", file=sys.stderr)
        return 2
    how = "served from store" if job.outcome == "cache_hit" \
        else "searched and stored"
    print(f"{how}  key={job.key}")
    print(_summary_line(job.artifact))
    if args.out:
        job.artifact.save(args.out)
        print(f"wrote {args.out}")
    return 0


def _cmd_serve(args) -> int:
    from repro_torch.serve import ArtifactStore, BatchScheduler
    from repro_torch.serve.scheduler import load_requests

    store = ArtifactStore(args.store)
    col = _env_collector()
    try:
        sched = BatchScheduler(store, workers=args.workers, obs=col,
                               device=args.device)
        for spec in load_requests(args.requests):
            sched.submit(spec)
        quiet = args.json
        outcome = sched.run(
            progress=None if quiet else lambda job: print(job.describe()))
    finally:
        if col is not None:
            col.close()
    if args.json:
        print(json.dumps(outcome.to_dict(), indent=2, sort_keys=True))
    else:
        s = outcome.stats
        print(f"stats: {s['jobs']} jobs — {s['searched']} searched, "
              f"{s['cache_hits']} cache hits "
              f"({s['deduped_in_flight']} deduped in-flight), "
              f"{s['failed']} failed; store holds {len(store)} schedules")
    return 1 if outcome.stats["failed"] else 0


def _cmd_report(args) -> int:
    from repro_torch.analysis import verify_artifact
    from repro_torch.search import ScheduleArtifact

    artifact = ScheduleArtifact.load(args.artifact)
    for w in artifact.load_warnings:
        print(f"warning: {w}", file=sys.stderr)
    if args.telemetry and artifact.telemetry is None:
        print("error: artifact carries no telemetry summary — re-run the "
              "search with --telemetry (or --trace / REPRO_TRACE)",
              file=sys.stderr)
        return 2
    s = artifact.summary()
    # independent re-verification + Chen-et-al lower-bound certificate
    # (repro_torch.analysis): static, no re-search
    report = verify_artifact(artifact)
    cert = report.certificate
    if args.json:
        s["verified"] = report.ok
        s["certificate"] = cert.to_dict() if cert else None
        if args.telemetry:
            s["telemetry"] = artifact.telemetry
        print(json.dumps(s, indent=2, sort_keys=True))
    else:
        print(f"workload     : {s['workload']} "
              f"(kwargs {artifact.spec.workload_kwargs})")
        print(f"accelerator  : {s['accelerator']}")
        print(f"backend      : {s['backend']} (seed {s['seed']}, "
              f"{artifact.evaluations} unique evals, "
              f"{artifact.wall_s:.1f}s)")
        print(f"costmodel    : {s['costmodel']}")
        print(f"objective    : {artifact.spec.objective} "
              f"(best fitness {artifact.best_fitness:.4f})")
        print(f"improvements : energy x{s['energy_x']}  edp x{s['edp_x']}  "
              f"cycles x{s['cycles_x']}  dram x{s['dram_x']}")
        print(f"schedule     : {s['groups']} fused groups, DRAM act-writes "
              f"{s['act_dram_writes_base']} -> {s['act_dram_writes_best']}")
        print(f"genome       : {artifact.genome_mask:#x} "
              f"({len(artifact.fused_edges)}/{artifact.n_edges} edges fused)")
        print(f"fingerprint  : {artifact.graph_fingerprint}")
        if cert is not None:
            print(f"certificate  : {cert.describe()}")
        verdict = "all checks passed" if report.ok else \
            "FAILED " + ", ".join(c.name for c in report.failures())
        print(f"verification : {verdict} (repro verify for detail)")
        if args.telemetry:
            from repro_torch.obs.report import render_telemetry
            print()
            print(render_telemetry(artifact.telemetry))
    if not args.json:
        from repro_torch.core.report import breakdown_report
        print()
        print(breakdown_report(artifact.group_breakdowns,
                               max_rows=0 if args.breakdown else 10))
    if args.history and artifact.history:
        h = artifact.history
        marks = sorted({0, len(h) // 4, len(h) // 2, 3 * len(h) // 4,
                        len(h) - 1})
        print("history      : "
              + "  ".join(f"s{i}={h[i]:.4f}" for i in marks))
    if args.schedule:
        from repro_torch.core.report import schedule_report
        from repro_torch.search.registry import build_accelerator
        res = _schedule_result(artifact)
        print()
        print(schedule_report(res, build_accelerator(
            artifact.spec.accelerator)))
    return 0


def _schedule_result(artifact):
    """Rebuild a ScheduleResult view from a stored artifact (validates the
    graph fingerprint; no re-search)."""
    from repro_torch.core.ga import GAResult
    from repro_torch.core.schedule import ScheduleResult
    state = artifact.rebuild_state()
    ga = GAResult(best_state=state, best_fitness=artifact.best_fitness,
                  history=list(artifact.history),
                  evaluations=artifact.evaluations,
                  offspring_evaluated=artifact.offspring_evaluated)
    return ScheduleResult(
        workload=artifact.spec.workload,
        accelerator=artifact.spec.accelerator,
        baseline=artifact.baseline, best=artifact.best,
        best_state=state, ga=ga)


def _cmd_verify(args) -> int:
    from repro_torch.analysis import verify_artifact, verify_store
    from repro_torch.search import ScheduleArtifact

    if not args.artifacts and not args.store:
        print("error: pass artifact paths and/or --store DIR",
              file=sys.stderr)
        return 2
    results = []                      # (label, load_warnings, report)
    col = _env_collector()
    try:
        for path in args.artifacts:
            artifact = ScheduleArtifact.load(path)
            results.append((path, list(artifact.load_warnings),
                            verify_artifact(artifact, obs=col)))
        if args.store:
            for key, report in verify_store(args.store, obs=col):
                results.append((f"{args.store}:{key[:12]}", [], report))
    finally:
        if col is not None:
            col.close()
    all_ok = all(r.ok for _, _, r in results)
    if args.json:
        print(json.dumps({
            "ok": all_ok,
            "results": [dict(label=label, load_warnings=warns,
                             **report.to_dict())
                        for label, warns, report in results],
        }, indent=2, sort_keys=True))
        return 0 if all_ok else 1
    for label, warns, report in results:
        print(f"{label}: {'verified' if report.ok else 'FAILED'}")
        for w in warns:
            print(f"  warning: {w}", file=sys.stderr)
        print(report.describe())
    n_bad = sum(1 for _, _, r in results if not r.ok)
    print(f"{len(results)} artifact(s): "
          f"{len(results) - n_bad} verified, {n_bad} failed")
    return 0 if all_ok else 1


def _cmd_trace(args) -> int:
    from repro_torch.obs.traceview import read_trace

    rep = read_trace(args.trace, top=args.top)
    if args.json:
        print(json.dumps(rep.to_dict(), indent=2, sort_keys=True))
    else:
        print(rep.describe())
    return 0 if rep.valid else 1


def _list_payload() -> dict:
    """The machine-readable registry dump behind ``repro list --json``."""
    import inspect

    from repro_torch.search import (ACCELERATORS, BACKENDS, COSTMODELS,
                                    OBJECTIVES, workload_schemas)
    return {
        "workloads": workload_schemas(),
        "workload_spec_forms": ["<name>", "<name>@key=value[,key=value...]",
                                "file:<model.json>"],
        "accelerators": ACCELERATORS.names(),
        "accelerator_spec_forms": ["<name>", "<name>@act+<KiB>",
                                   "<name>@act-<KiB>"],
        "objectives": OBJECTIVES.names(),
        "backends": {name: {"doc": inspect.getdoc(BACKENDS.get(name)) or ""}
                     for name in BACKENDS},
        "costmodels": COSTMODELS.names(),
    }


def _list_store(root: str, as_json: bool) -> int:
    """``repro list --store DIR``: browse a schedule store, surfacing each
    object's load warnings (corrupt/legacy objects stay visible instead of
    only erroring at report time)."""
    from repro_torch.serve import ArtifactStore, StoreError

    store = ArtifactStore(root, create=False)
    rows = []
    for key in store.keys():
        try:
            artifact = store.load_key(key)
        except StoreError as e:
            rows.append({"key": key, "error": str(e)})
            continue
        if artifact is None:
            continue
        rows.append({"key": key, "summary": artifact.summary(),
                     "load_warnings": list(artifact.load_warnings),
                     "artifact": artifact})
    if as_json:
        print(json.dumps([{k: v for k, v in row.items() if k != "artifact"}
                          for row in rows], indent=2, sort_keys=True))
        return 0
    for row in rows:
        if "error" in row:
            print(f"{row['key'][:12]}  UNREADABLE: {row['error']}")
            continue
        print(f"{row['key'][:12]}  {_summary_line(row['artifact'])}")
        for w in row["load_warnings"]:
            print(f"{'':12}  warning: {w}")
    n_bad = sum(1 for r in rows if "error" in r)
    n_warn = sum(1 for r in rows if r.get("load_warnings"))
    print(f"{len(rows)} object(s) in {root}"
          + (f" — {n_bad} unreadable" if n_bad else "")
          + (f", {n_warn} with load warnings" if n_warn else ""))
    return 0


def _cmd_list(args) -> int:
    import inspect

    from repro_torch.search import (ACCELERATORS, BACKENDS, COSTMODELS,
                                    OBJECTIVES, WORKLOADS, workload_schemas)
    if getattr(args, "store", None):
        return _list_store(args.store, as_json=getattr(args, "json", False))
    if getattr(args, "json", False):
        print(json.dumps(_list_payload(), indent=2, sort_keys=True))
        return 0
    for reg in (WORKLOADS, ACCELERATORS, OBJECTIVES, BACKENDS, COSTMODELS):
        print(f"{reg.kind}s: " + ", ".join(reg.names()))
    print("(accelerators accept an iso-capacity repartition suffix: "
          "eyeriss@act+64; `repro_torch.hw` holds their hierarchical descriptions)")
    print()
    print("workloads (params go in --workload name@key=value,... or "
          "--workload-kwargs JSON; file:model.json imports GraphIR):")
    for name, info in sorted(workload_schemas().items()):
        params = ", ".join(f"{k}={v['default']!r} ({v['type']})"
                           for k, v in info["params"].items()) or "(none)"
        print(f"  {name}: {params}")
    print()
    print("backends (config knobs go in --backend-config JSON):")
    for name in BACKENDS:
        doc = inspect.getdoc(BACKENDS.get(name)) or "(undocumented)"
        print(f"\n  {name}:")
        for line in doc.splitlines():
            print(f"    {line}".rstrip())
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch",
        description="GA-driven interlayer pipelining on PyTorch/CUDA: "
                    "search schedules, serve batches, report artifacts.")
    sub = ap.add_subparsers(dest="command", required=True)
    _add_search_parser(sub)
    _add_submit_parser(sub)
    _add_serve_parser(sub)
    _add_report_parser(sub)
    _add_verify_parser(sub)
    _add_trace_parser(sub)
    _add_unported_parsers(sub)
    lp = sub.add_parser(
        "list", help="list registered workloads / accelerators / "
                     "objectives / backends (with config knobs), or "
                     "browse a schedule store with --store")
    lp.add_argument("--json", action="store_true",
                    help="machine-readable dump: workloads with param "
                         "schemas, accelerators, objectives, backends "
                         "(with docs), costmodels")
    lp.add_argument("--store", default=None, metavar="DIR",
                    help="list the artifacts in an ArtifactStore instead "
                         "(shows per-object load warnings)")
    args, extra = ap.parse_known_args(argv)
    if args.command in UNPORTED:
        print(f"error: `{args.command}` is not ported to repro_torch yet: "
              f"{UNPORTED[args.command]}; run it with the reference "
              f"(python -m repro {args.command})", file=sys.stderr)
        return 2
    if extra:
        ap.error(f"unrecognized arguments: {' '.join(extra)}")

    from repro_torch.device import resolve_device
    from repro_torch.search import (BackendError, FingerprintMismatch,
                                    RegistryError)
    from repro_torch.serve import StoreError
    handler = {"search": _cmd_search, "submit": _cmd_submit,
               "serve": _cmd_serve, "report": _cmd_report,
               "verify": _cmd_verify, "trace": _cmd_trace,
               "list": _cmd_list}[args.command]
    try:
        if hasattr(args, "device"):
            try:
                resolve_device(args.device)     # no card: say so, exit 2
            except RuntimeError as e:
                print(f"error: {e} (--device cpu)", file=sys.stderr)
                return 2
        return handler(args)
    except BrokenPipeError:
        # `report ... | head`: exit quietly; route stdout to devnull
        # so the interpreter's shutdown flush doesn't raise again
        devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull, sys.stdout.fileno())
        return 0
    except (RegistryError, BackendError, FingerprintMismatch, StoreError,
            FileNotFoundError, json.JSONDecodeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
