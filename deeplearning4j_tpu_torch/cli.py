"""Command-line entry point (counterpart of deeplearning4j_tpu/cli.py:
the same subcommands, arguments, printed tables and exit codes).

Mirrors ParallelWrapperMain (parallelism/main/ParallelWrapperMain.java):
load a serialized model, train it data-parallel from a CSV source,
optionally serving dashboard stats, then save.

    python -m deeplearning4j_tpu_torch.cli train \
        --model model.zip --data train.csv --label-index -1 --num-classes 3 \
        --epochs 5 --batch 64 --ui-port 9000 --out trained.zip

Subcommands: train, evaluate, summary, checkpoints, trace export|summary,
postmortem, fleet status|trace|slo, serve rollout, serve fleet, slo and
import-keras, as in the JAX package. The commands that build a network
(train, evaluate, summary, import-keras) take ``--device`` (default: the
CUDA card, which raises where there is none; ``cpu`` asks for the CPU).
``train`` runs ParallelWrapper over the process group it finds, or over
one it starts at world size 1 (NCCL on the card, gloo on the CPU) and
closes when the fit ends; ``--workers`` is the data axis's width (0: the
group's world size).

Still missing, each refused with exit code 2 and its ROADMAP item named:
analyze and lint (analysis/*, A.11 item 6), profile (telemetry/
profiler.py, item 3), tune and config (the tuner and the knob registry,
item 4) and knn-server (knn/*, item 6).
"""
from __future__ import annotations

import argparse
import json
import sys


def _iterator(args):
    from deeplearning4j_tpu_torch.datasets.records import (
        CSVRecordReader,
        RecordReaderDataSetIterator,
    )

    reader = CSVRecordReader(args.data, skip_lines=args.skip_lines)
    return RecordReaderDataSetIterator(
        reader, batch=args.batch, label_index=args.label_index,
        num_classes=args.num_classes,
        regression=args.num_classes is None)


def _process_group(device):
    """The process group a ParallelWrapper runs over: the caller's when one
    is initialised (returns None), else a new one at world size 1, NCCL on
    the card and gloo on the CPU, whose rendezvous directory it returns
    (the caller closes the group, then removes the directory)."""
    import os
    import tempfile

    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel import init_process_group

    if dist.is_initialized():
        return None
    rdv = tempfile.mkdtemp(prefix="dl4j_cli_rdv_")
    init_process_group(f"file://{os.path.join(rdv, 'rdv')}", 0, 1,
                       device=device)
    return rdv


def cmd_train(args):
    import shutil

    import torch.distributed as dist

    from deeplearning4j_tpu_torch.models import restore_model, write_model
    from deeplearning4j_tpu_torch.parallel import MeshSpec, ParallelWrapper
    from deeplearning4j_tpu_torch.optimize.listeners import (
        PerformanceListener,
        ScoreIterationListener,
    )

    net = restore_model(args.model, device=args.device)
    net.add_listeners(ScoreIterationListener(args.print_every),
                      PerformanceListener(args.print_every))
    if args.ui_port:
        from deeplearning4j_tpu_torch.ui import (
            InMemoryStatsStorage,
            StatsListener,
            UIServer,
        )

        storage = InMemoryStatsStorage()
        net.add_listeners(StatsListener(storage))
        server = UIServer.get_instance(args.ui_port)
        server.attach(storage)
        print(f"dashboard: {server.url()}/train/overview")
    own_rdv = _process_group(net.device)
    try:
        spec = MeshSpec(data=args.workers) if args.workers else None
        pw = ParallelWrapper(net, mesh_spec=spec,
                             prefetch_buffer=args.prefetch)
        pw.fit(_iterator(args), epochs=args.epochs)
        pw.sync_to_host()
        write_model(net, args.out or args.model)
    finally:
        if own_rdv is not None:
            dist.destroy_process_group()
            shutil.rmtree(own_rdv, ignore_errors=True)
    print(f"saved {args.out or args.model} (score={net.score_:.5f})")
    return 0


def cmd_evaluate(args):
    from deeplearning4j_tpu_torch.models import restore_model

    net = restore_model(args.model, device=args.device)
    ev = net.evaluate(_iterator(args))
    print(ev.stats())
    return 0


def cmd_summary(args):
    from deeplearning4j_tpu_torch.models import restore_model
    from deeplearning4j_tpu_torch.nn.memory import memory_report

    net = restore_model(args.model, device=args.device)
    print(net.summary())
    if not hasattr(net.conf, "layers"):
        # memory reports cover sequential configs; keep --json consumers fed
        if args.json:
            print(json.dumps({"total_params": net.num_params(),
                              "memory_report": None}))
        return 0
    rep = memory_report(net.conf)
    print()
    print(rep.summary(batch=args.batch))
    if args.json:
        print(json.dumps(rep.to_json()))
    return 0


# the commands whose modules are not ported yet: each prints a refusal
# naming its ROADMAP item and exits 2
_NOT_PORTED = {
    "analyze": "analysis/* (the graph analyzer; ROADMAP A.11 item 6)",
    "lint": "analysis/* (the linters; ROADMAP A.11 item 6)",
    "profile": "telemetry/introspect.py and profiler.py "
               "(ROADMAP A.11 item 3)",
    "tune": "telemetry/tuner.py and tuning/* (ROADMAP A.11 item 4)",
    "config": "the knob registry in util/envflags.py "
              "(ROADMAP A.11 item 4)",
    "knn-server": "knn/* (ROADMAP A.11 item 6)",
}


def cmd_not_ported(args):
    print(f"{args.cmd}: not ported yet: it needs "
          f"{_NOT_PORTED[args.cmd]}")
    return 2


def cmd_checkpoints(args):
    """Operate on a resilience checkpoint directory: list manifests,
    verify payload checksums, prune to a keep policy. Exit 1 when --verify
    finds any bad checkpoint."""
    import os

    from deeplearning4j_tpu_torch.resilience import CheckpointManager

    # an inspection command must not create the directory it inspects —
    # a typo'd --dir should fail loudly, not mint an empty dir and pass
    if not os.path.isdir(args.dir):
        print(f"checkpoint directory not found: {args.dir}")
        return 1
    cm = CheckpointManager(args.dir, keep_last=args.keep_last,
                           keep_every=args.keep_every, prefix=args.prefix)
    if args.prune:
        removed = cm.prune()
        print(f"pruned {len(removed)} checkpoint(s): "
              f"{removed if removed else '(none)'}")
    rows = []
    all_ok = True
    for m in cm.manifests():
        step = int(m["step"])
        status = ""
        if args.verify:
            ok, status = cm.verify(step)
            all_ok = all_ok and ok
        rows.append({
            "step": step,
            "iteration": m.get("iteration"),
            "epoch": m.get("epoch"),
            "score": m.get("score"),
            "size_bytes": m.get("size_bytes"),
            "sha256": m.get("sha256"),
            "status": status or None,
        })
    if args.json:
        print(json.dumps(rows, indent=2))
    else:
        hdr = f"{'step':>10} {'epoch':>6} {'iter':>8} {'score':>12} {'size':>10}"
        if args.verify:
            hdr += "  status"
        print(hdr)
        for r in rows:
            score = ("-" if r["score"] is None
                     else f"{float(r['score']):.5f}")
            size = ("-" if r["size_bytes"] is None
                    else str(r["size_bytes"]))
            epoch = "-" if r["epoch"] is None else str(r["epoch"])
            iter_ = "-" if r["iteration"] is None else str(r["iteration"])
            line = (f"{r['step']:>10} {epoch:>6} {iter_:>8} {score:>12} "
                    f"{size:>10}")
            if args.verify:
                line += f"  {r['status']}"
            print(line)
        print(f"{len(rows)} checkpoint(s) in {args.dir}")
    if args.verify and not rows:
        # verifying nothing is not a healthy state for a health check
        return 1
    return 0 if all_ok else 1


def _load_trace_spans(path):
    """-> (kind, spans, introspection) from either telemetry file format:
    Chrome trace-event JSON ({"traceEvents": [...]}) or a distributed
    TrainingStats export ({"events": [...]} / bare event list). `spans`
    is [(name, duration_ms)]; `introspection` collects the compile-
    watcher artifacts (compile spans, retrace instant events) present in
    Chrome traces so `trace summary` can answer "why was this run slow"
    in one table."""
    with open(path) as f:
        doc = json.load(f)
    spans = []
    intro = {"compile_count": 0, "compile_ms": 0.0, "retraces": {}}
    if isinstance(doc, dict) and "traceEvents" in doc:
        for ev in doc["traceEvents"]:
            if ev.get("ph") == "X" and "dur" in ev:
                spans.append((str(ev.get("name")), float(ev["dur"]) / 1e3))
                if ev.get("cat") == "compile":
                    intro["compile_count"] += 1
                    intro["compile_ms"] += float(ev["dur"]) / 1e3
            elif ev.get("ph") == "i" and ev.get("name") == "retrace":
                fn = (ev.get("args") or {}).get("fn", "?")
                intro["retraces"][fn] = intro["retraces"].get(fn, 0) + 1
        return "chrome", spans, intro
    events = doc.get("events", doc) if isinstance(doc, dict) else doc
    for e in events:
        if isinstance(e, dict) and "key" in e and "duration_ms" in e:
            spans.append((str(e["key"]), float(e["duration_ms"])))
    return "stats", spans, intro


def cmd_trace(args):
    """`trace export`: TrainingStats JSON -> Chrome trace-event JSON
    (one lane per worker; open in Perfetto / chrome://tracing).
    `trace summary`: per-phase count/total/mean/p50 table over either
    format. Exit 1 when the input holds no recognizable spans."""
    from deeplearning4j_tpu_torch.telemetry.trace import Tracer

    if args.action == "export":
        with open(args.stats) as f:
            doc = json.load(f)
        if isinstance(doc, dict) and "traceEvents" in doc:
            print(f"{args.stats} is already a Chrome trace")
            return 1
        # offline file converter: a throwaway ring, nothing here should
        # reach the live fleet pane
        tracer = Tracer(capacity=1 << 20)
        n = tracer.merge_training_stats(doc)
        if not n:
            print(f"no events found in {args.stats}")
            return 1
        tracer.export_chrome(args.out)
        print(f"wrote {n} span(s) -> {args.out} "
              f"(open in https://ui.perfetto.dev or chrome://tracing)")
        return 0

    kind, spans, intro = _load_trace_spans(args.file)
    if not spans:
        print(f"no spans found in {args.file}")
        return 1
    # one stats schema: pour the loaded spans into a Tracer and reuse its
    # summary() (the same shape BENCH_DETAIL['telemetry']['phases'] carries)
    # summarizing a loaded file, not recording live spans; deliberately
    # not the process ring
    tracer = Tracer(capacity=len(spans),
                    enabled=True)
    for name, dur in spans:
        tracer.add_span(name, dur)
    summary = tracer.summary()
    if args.json:
        out = dict(summary)
        if intro["compile_count"] or intro["retraces"]:
            out["_introspection"] = intro
        print(json.dumps(out, indent=2))
        return 0
    print(f"{'phase':<28} {'count':>7} {'total_ms':>12} {'mean_ms':>10} "
          f"{'p50_ms':>10} {'max_ms':>10}")
    for name, s in summary.items():
        print(f"{name:<28} {s['count']:>7} {s['total_ms']:>12.1f} "
              f"{s['mean_ms']:>10.2f} {s['p50_ms']:>10.2f} "
              f"{s['max_ms']:>10.2f}")
    print(f"{len(spans)} span(s) in {args.file} ({kind} format)")
    # the "why was this run slow" lines: compile time spent and retrace
    # storms, straight from the compile watcher's artifacts in the trace
    if intro["compile_count"]:
        print(f"compile: {intro['compile_count']} compilation(s), "
              f"{intro['compile_ms']:.1f} ms total")
    if intro["retraces"]:
        for fn, n in sorted(intro["retraces"].items()):
            print(f"retrace warning: {fn} recompiled past the threshold "
                  f"({n} event(s)) — see docs/PROFILING.md")
    return 0


def cmd_postmortem(args):
    """Inspect black-box flight-recorder bundles (telemetry/flight.py):
    list every bundle under the flight dir, or summarize one (--file):
    reason, exception traceback tail, health verdict, per-phase span
    table from the embedded Chrome trace, stragglers. Exit 1 when the
    directory holds no bundles (a missing black box is itself a
    finding). docs/HEALTH.md."""
    import os

    from deeplearning4j_tpu_torch.telemetry import flight as flight_mod

    if args.file:
        try:
            bundle = flight_mod.load_bundle(args.file)
        except (OSError, ValueError) as e:
            print(f"unreadable bundle {args.file}: {e}")
            return 1
        if args.json:
            print(json.dumps(bundle, indent=2))
        else:
            print(flight_mod.summarize(bundle))
        return 0
    # --dir repeats: a cross-host incident leaves per-host/per-replica
    # flight dirs; list them as one inventory (and --fleet joins them)
    dirs = list(args.dir) if args.dir else [flight_mod.flight_dir()]
    directory = ", ".join(dirs)
    paths = []
    for d in dirs:
        paths.extend(flight_mod.list_bundles(d))
    if not paths:
        print(f"no flight bundles in {directory}")
        return 1
    if getattr(args, "fleet", False):
        return _postmortem_fleet(paths, args)
    rows = []
    for p in paths:
        try:
            b = flight_mod.load_bundle(p)
        except (OSError, ValueError) as e:
            rows.append({"path": p, "error": f"unreadable: {e}"})
            continue
        # pre-PR10 bundles have no trace_id key: None, never a KeyError
        trace_id = b.get("trace_id")
        if getattr(args, "trace", None):
            # an slo_burn bundle has no trace of its own (the episode
            # fires from a tick, not a request) — its join keys are the
            # offending trace ids it recorded
            offending = ((b.get("slo") or {}).get("offending_traces")
                         or (b.get("canary") or {}).get("offending_traces")
                         or ())
            if trace_id != args.trace and args.trace not in offending:
                continue
        if getattr(args, "reason", None) and \
                b.get("reason") != args.reason:
            continue
        exc = b.get("exception") or {}
        health = b.get("health") or {}
        rows.append({
            "path": p,
            "reason": b.get("reason"),
            "time": b.get("time"),
            "phase": health.get("phase"),
            "iteration": health.get("iteration"),
            "exception": exc.get("type"),
            "trace_id": trace_id,
            # multi-controller host id (null for single-process bundles
            # and pre-PR13 bundles alike — .get, never a KeyError)
            "process_index": b.get("process_index"),
            "input_verdict": (b.get("input_pipeline") or {}).get("verdict"),
        })
    if not rows and (getattr(args, "trace", None)
                     or getattr(args, "reason", None)):
        wanted = (f"trace_id {args.trace}" if getattr(args, "trace", None)
                  else f"reason {args.reason}")
        print(f"no bundles with {wanted} in {directory}")
        return 1
    if args.json:
        print(json.dumps(rows, indent=2))
        return 0
    print(f"{'bundle':<44} {'reason':>10} {'host':>5} {'iter':>8} "
          f"{'exception':>18} {'trace_id':>18}")
    for r in rows:
        name = os.path.basename(r["path"])
        if "error" in r:
            print(f"{name:<44} {r['error']}")
            continue
        host = "-" if r.get("process_index") is None \
            else str(r["process_index"])
        print(f"{name:<44} {str(r['reason']):>10} {host:>5} "
              f"{str(r['iteration']):>8} {str(r['exception']):>18} "
              f"{str(r['trace_id']):>18}")
    print(f"{len(rows)} bundle(s) in {directory} "
          f"(summarize one with --file)")
    return 0


def _postmortem_fleet(paths, args):
    """``postmortem --fleet``: join bundles ACROSS flight dirs by
    trace_id (bundles stamp ``process_index``, slo/canary bundles carry
    offending trace ids), so a cross-host incident reads as ONE
    postmortem instead of N disjoint per-host listings."""
    import os

    from deeplearning4j_tpu_torch.telemetry import flight as flight_mod

    groups = {}  # trace_id -> [(time, host, reason, path)]
    unjoined = []
    for p in paths:
        try:
            b = flight_mod.load_bundle(p)
        except (OSError, ValueError) as e:
            unjoined.append((p, f"unreadable: {e}"))
            continue
        tids = set()
        if b.get("trace_id"):
            tids.add(b["trace_id"])
        for sec in ("slo", "canary"):
            tids.update((b.get(sec) or {}).get("offending_traces") or ())
        for ev in ((b.get("fleet") or {}).get("joined_trace_events")
                   or ()):
            if ev.get("trace_id"):
                tids.add(ev["trace_id"])
        host = b.get("process_index")
        entry = (b.get("time"), "-" if host is None else str(host),
                 b.get("reason"), p)
        if not tids:
            unjoined.append((p, f"no trace_id (reason "
                                f"{b.get('reason')})"))
            continue
        if getattr(args, "trace", None) and args.trace not in tids:
            continue
        for t in sorted(tids):
            groups.setdefault(t, []).append(entry)
    if args.json:
        print(json.dumps({
            "incidents": {t: [{"time": e[0], "host": e[1],
                               "reason": e[2], "path": e[3]}
                              for e in sorted(es)]
                          for t, es in sorted(groups.items())},
            "unjoined": [{"path": p, "note": n} for p, n in unjoined],
        }, indent=2))
        return 0 if groups else 1
    if not groups:
        print("no joinable bundles (none carry a trace_id)")
        return 1
    for t, es in sorted(groups.items()):
        hosts = sorted({e[1] for e in es})
        print(f"incident trace_id={t}  bundles={len(es)}  "
              f"hosts={','.join(hosts)}")
        for time_, host, reason, p in sorted(es):
            print(f"  {str(time_):<20} host={host:<4} "
                  f"{str(reason):<16} {os.path.basename(p)}")
    if unjoined:
        print(f"{len(unjoined)} bundle(s) without a trace_id "
              f"(listed with plain postmortem)")
    return 0


def cmd_fleet(args):
    """``fleet status|trace|slo``: the federated one-pane-of-glass
    (telemetry/aggregate.py). With --url, fetch a live process's
    /fleet/* endpoints (each fetch ticks the collector's poll — the
    CLI IS the cadence). With --spool, merge frame spools offline (a
    post-run DCN coordinator view; no server needed). ``slo`` exits 2
    while any federated rule fires. docs/TELEMETRY.md."""
    import urllib.error
    import urllib.request

    spools = list(getattr(args, "spool", None) or ())
    if spools:
        from deeplearning4j_tpu_torch.telemetry import aggregate as agg_mod
        from deeplearning4j_tpu_torch.telemetry import slo as slo_mod

        coll = agg_mod.FleetCollector()
        for d in spools:
            coll.attach_spool(d)
        coll.poll()
        coll.finalize()
        if args.action == "status":
            doc = coll.status()
            print(json.dumps(doc, indent=2) if args.json
                  else _render_fleet_status(doc))
            return 0
        if args.action == "trace":
            doc = coll.merged_chrome_trace()
            if args.out:
                with open(args.out, "w") as f:
                    json.dump(doc, f)
                print(f"merged {len(doc['traceEvents'])} events from "
                      f"{len(doc['fleet']['sources'])} source(s) -> "
                      f"{args.out}")
            else:
                print(json.dumps(doc))
            return 0
        rows = coll.slo_engine().tick() or []
        print(json.dumps(rows, indent=2) if args.json
              else slo_mod.render_status(rows))
        return 2 if any(r["firing"] for r in rows) else 0

    path = {"status": "/fleet/status", "trace": "/fleet/trace",
            "slo": "/fleet/slo"}[args.action]
    url = args.url.rstrip("/") + path
    try:
        with urllib.request.urlopen(url, timeout=args.timeout) as resp:
            doc = json.loads(resp.read())
    except urllib.error.HTTPError as e:
        if e.code == 404:
            print(f"no fleet collector at {args.url} "
                  f"(telemetry gate off?)")
            return 1
        print(f"fetch failed: {url}: {e}")
        return 1
    except (urllib.error.URLError, OSError, ValueError) as e:
        print(f"fetch failed: {url}: {e}")
        return 1
    if args.action == "trace":
        if args.out:
            with open(args.out, "w") as f:
                json.dump(doc, f)
            print(f"merged {len(doc.get('traceEvents', []))} events -> "
                  f"{args.out}")
        else:
            print(json.dumps(doc))
        return 0
    if args.action == "slo":
        from deeplearning4j_tpu_torch.telemetry import slo as slo_mod

        rows = doc.get("slo") or []
        print(json.dumps(rows, indent=2) if args.json
              else slo_mod.render_status(rows))
        return 2 if any(r.get("firing") for r in rows) else 0
    print(json.dumps(doc, indent=2) if args.json
          else _render_fleet_status(doc))
    return 0


def _render_fleet_status(doc) -> str:
    lines = [f"{'host':<16} {'replica':<12} {'live':>4} {'frames':>7} "
             f"{'seq':>6} {'missing':>7} {'spans':>7} {'skew_ms':>8}"]
    for s in doc.get("sources", []):
        skew = s.get("clock_skew_s")
        skew_txt = "-" if skew is None else f"{skew * 1e3:+.2f}"
        lines.append(
            f"{s['host']:<16} {s['replica']:<12} "
            f"{'y' if s['live'] else '-':>4} {s['frames']:>7} "
            f"{s['max_seq']:>6} {s['missing']:>7} "
            f"{s['trace_records']:>7} {skew_txt:>8}")
    if not doc.get("sources"):
        lines.append("(no sources registered)")
    return "\n".join(lines)


def cmd_serve(args):
    """`serve rollout`: fetch a serving process's /models endpoint
    (ui/server.py; each fetch ticks the rollout control loop) and render
    the fleet — model/version inventory plus the canary ramp table.
    Exit 2 while any rollout is rolled back (the pager-visible state),
    1 when the process has no serving fleet. docs/SERVING.md."""
    import urllib.error
    import urllib.request

    url = args.url.rstrip("/") + "/models"
    try:
        with urllib.request.urlopen(url, timeout=args.timeout) as resp:
            doc = json.loads(resp.read())
    except urllib.error.HTTPError as e:
        if e.code == 404:
            print(f"no serving fleet at {args.url}")
            return 1
        print(f"fetch failed: {url}: {e}")
        return 1
    except (urllib.error.URLError, OSError, ValueError) as e:
        print(f"fetch failed: {url}: {e}")
        return 1
    if args.json:
        print(json.dumps(doc, indent=2))
    # a multi-router process nests snapshots; normalize to a list
    snaps = doc.get("routers") or doc.get("registries") or [doc]
    rolled_back = False
    if not args.json:
        for snap in snaps:
            for name, m in sorted((snap.get("models") or {}).items()):
                versions = ", ".join(
                    v["version"]
                    + ("*" if v["version"] == m.get("stable") else "")
                    + ("c" if v.get("canary") else "")
                    for v in m.get("versions", []))
                print(f"{name:<24} stable={str(m.get('stable')):<10} "
                      f"versions: {versions}")
            rollouts = snap.get("rollouts", [])
            if rollouts:
                print()
                print(f"{'model':<24} {'canary':>10} {'state':>12} "
                      f"{'ramp %':>7} {'history':>24}")
            for ro in rollouts:
                pct = int(round(ro["fraction"] * 100))
                print(f"{ro['model']:<24} {ro['canary']:>10} "
                      f"{ro['state']:>12} {pct:>7} "
                      f"{'->'.join(ro['history']):>24}")
                if ro.get("rollback_bundle"):
                    print(f"  rollback bundle: {ro['rollback_bundle']}")
    for snap in snaps:
        rolled_back = rolled_back or any(
            ro.get("state") == "rolled_back"
            for ro in snap.get("rollouts", []))
    return 2 if rolled_back else 0


def cmd_serve_fleet(args):
    """`serve fleet`: fetch a serving process's /fleet endpoint
    (ui/server.py; each fetch ticks the autoscaler control loop) and
    render the replica table plus per-tenant quota/shed/latency rows.
    Exit 2 while a scale-storm guard or any per-tenant SLO rule is
    firing (the pager-visible states), 1 when the process has no
    autoscaled pool. docs/SERVING.md."""
    import urllib.error
    import urllib.request

    url = args.url.rstrip("/") + "/fleet"
    try:
        with urllib.request.urlopen(url, timeout=args.timeout) as resp:
            doc = json.loads(resp.read())
    except urllib.error.HTTPError as e:
        if e.code == 404:
            print(f"no autoscaled pool at {args.url}")
            return 1
        print(f"fetch failed: {url}: {e}")
        return 1
    except (urllib.error.URLError, OSError, ValueError) as e:
        print(f"fetch failed: {url}: {e}")
        return 1
    if args.json:
        print(json.dumps(doc, indent=2))
    else:
        for pool in doc.get("pools", []):
            sig = pool.get("signals") or {}
            ema = sig.get("ema_latency_s")
            ema_txt = f"  ema={ema * 1e3:.1f}ms" if ema is not None else ""
            print(f"{pool['name']}  v={pool['version']}  "
                  f"replicas={pool['replicas_live']} "
                  f"[{pool['min_replicas']}..{pool['max_replicas']}]  "
                  f"queue_p50={sig.get('queue_depth_p50', 0):.1f}"
                  f"{ema_txt}")
            if pool.get("storm_guard_active"):
                print("  storm guard: ACTIVE (inside min dwell)")
            spawn = pool.get("spawn") or {}
            if spawn.get("episode_open"):
                print(f"  spawn episode: {spawn['failures']} failure(s), "
                      f"retry in {spawn['retry_in_s']}s")
            print(f"  {'replica':<20} {'state':>8} {'depth':>6} "
                  f"{'ema ms':>8}")
            for r in pool.get("replica_servers", []):
                rema = r.get("ema_latency_s")
                print(f"  {r['replica_id']:<20} {r['state']:>8} "
                      f"{r['queue_depth']:>6} "
                      f"{(rema * 1e3 if rema else 0.0):>8.1f}")
            tenants = pool.get("tenants")
            if tenants:
                print(f"  {'tenant':<16} {'rate':>8} {'weight':>7} "
                      f"{'admitted':>9} {'shed':>6} {'p99 ms':>8}")
                for name, t in sorted(tenants.items()):
                    p99 = t.get("latency_p99_s")
                    print(f"  {name:<16} {t['rate']:>8g} "
                          f"{t['weight']:>7g} {t['admitted']:>9} "
                          f"{t['shed']:>6} "
                          f"{(p99 * 1e3 if p99 else 0.0):>8.1f}")
            firing = pool.get("tenant_slo_firing") or []
            if firing:
                print(f"  tenant SLOs firing: {', '.join(firing)}")
            events = pool.get("events") or []
            if events:
                tail = events[-5:]
                print("  recent: " + "; ".join(
                    f"{e['direction']}/{e['reason']}" for e in tail))
    gate = (doc.get("storm_guard_active")
            or bool(doc.get("tenant_slo_firing")))
    return 2 if gate else 0


def cmd_slo(args):
    """SLO burn-rate status (telemetry/slo.py): tick the engine twice
    over --interval seconds (burn rates are deltas — one sample has no
    rate) and print the per-rule table. Exit 2 while any rule fires,
    1 when the telemetry gate is off. docs/TELEMETRY.md."""
    import time as time_mod

    from deeplearning4j_tpu_torch.telemetry import slo as slo_mod
    from deeplearning4j_tpu_torch.telemetry import trace as trace_mod

    if not trace_mod.tracer().enabled:
        print("telemetry gate off — set DL4J_TPU_TELEMETRY=1")
        return 1
    slo_mod.tick()
    if args.interval > 0:
        time_mod.sleep(args.interval)
    rows = slo_mod.tick()
    if args.json:
        print(json.dumps(rows, indent=2))
    else:
        print(slo_mod.render_status(rows))
    return 2 if any(r["firing"] for r in rows) else 0


def cmd_import_keras(args):
    """Convert a Keras h5 model to the native checkpoint zip — the
    KerasModelImport migration path as a one-liner."""
    from deeplearning4j_tpu_torch.modelimport import import_keras_model_and_weights
    from deeplearning4j_tpu_torch.models.serialization import write_model

    net = import_keras_model_and_weights(args.h5, device=args.device)
    write_model(net, args.out)
    n = net.num_params()
    print(f"imported {args.h5} -> {args.out} ({n/1e6:.2f}M params)")
    return 0


def _common_data_args(p):
    p.add_argument("--data", required=True, help="CSV file")
    p.add_argument("--skip-lines", type=int, default=0)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--label-index", type=int, default=-1)
    p.add_argument("--num-classes", type=int, default=None,
                   help="omit for regression")


def _device_arg(p):
    p.add_argument("--device", default=None,
                   help="torch device to build the network on (default: "
                        "the CUDA card; 'cpu' for the CPU)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="deeplearning4j_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="data-parallel training")
    t.add_argument("--model", required=True, help="model zip")
    _common_data_args(t)
    t.add_argument("--epochs", type=int, default=1)
    t.add_argument("--workers", type=int, default=0,
                   help="data-parallel width (0 = the process group's "
                        "world size)")
    t.add_argument("--prefetch", type=int, default=4)
    t.add_argument("--print-every", type=int, default=10)
    t.add_argument("--ui-port", type=int, default=0)
    t.add_argument("--out", default=None)
    _device_arg(t)
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("evaluate", help="evaluate a model on CSV data")
    e.add_argument("--model", required=True)
    _common_data_args(e)
    _device_arg(e)
    e.set_defaults(fn=cmd_evaluate)

    s = sub.add_parser("summary", help="architecture + memory report")
    s.add_argument("--model", required=True)
    s.add_argument("--batch", type=int, default=32)
    s.add_argument("--json", action="store_true")
    _device_arg(s)
    s.set_defaults(fn=cmd_summary)

    c = sub.add_parser("checkpoints",
                       help="list/verify/prune a resilience checkpoint "
                            "directory")
    c.add_argument("--dir", required=True, help="checkpoint directory")
    c.add_argument("--prefix", default="checkpoint")
    c.add_argument("--verify", action="store_true",
                   help="re-hash payloads against manifests (exit 1 on "
                        "any failure)")
    c.add_argument("--prune", action="store_true",
                   help="apply the keep policy before listing")
    c.add_argument("--keep-last", type=int, default=3)
    c.add_argument("--keep-every", type=int, default=0,
                   help="steps that are multiples of this never prune "
                        "(0 = off)")
    c.add_argument("--json", action="store_true")
    c.set_defaults(fn=cmd_checkpoints)

    tr = sub.add_parser("trace",
                        help="convert/summarize telemetry traces")
    tr_sub = tr.add_subparsers(dest="action", required=True)
    te = tr_sub.add_parser("export",
                           help="TrainingStats JSON -> Chrome trace JSON")
    te.add_argument("--stats", required=True,
                    help="TrainingStats.export_json file")
    te.add_argument("--out", required=True, help="Chrome trace output path")
    te.set_defaults(fn=cmd_trace)
    ts = tr_sub.add_parser("summary",
                           help="per-phase duration table for a trace")
    ts.add_argument("--file", required=True,
                    help="Chrome trace JSON or TrainingStats JSON")
    ts.add_argument("--json", action="store_true")
    ts.set_defaults(fn=cmd_trace)

    pm = sub.add_parser("postmortem",
                        help="list/summarize flight-recorder bundles")
    pm.add_argument("--dir", action="append", default=None,
                    help="flight directory (repeatable — one per host's "
                         "flight dir; default: DL4J_TPU_FLIGHT_DIR)")
    pm.add_argument("--file", default=None,
                    help="summarize one bundle instead of listing")
    pm.add_argument("--json", action="store_true")
    pm.add_argument("--trace", default=None,
                    help="only bundles recorded under this trace_id")
    pm.add_argument("--reason", default=None,
                    help="only bundles with this reason (e.g. "
                         "canary_rollback, slo_burn)")
    pm.add_argument("--fleet", action="store_true",
                    help="join bundles across --dir's by trace_id into "
                         "cross-host incident groups")
    pm.set_defaults(fn=cmd_postmortem)

    fl = sub.add_parser("fleet",
                        help="federated telemetry across hosts/replicas "
                             "(telemetry/aggregate.py)")
    fl_sub = fl.add_subparsers(dest="action", required=True)
    for act, hlp in (("status", "per-source frame/seq/skew table"),
                     ("trace", "ONE merged Chrome trace, lane group "
                               "per host"),
                     ("slo", "federated burn-rate rows (exit 2 while "
                             "firing)")):
        fp = fl_sub.add_parser(act, help=hlp)
        fp.add_argument("--url", default="http://127.0.0.1:9000",
                        help="a live process's UI base URL "
                             "(/fleet/* endpoints)")
        fp.add_argument("--spool", action="append", default=None,
                        metavar="DIR",
                        help="merge frame spool dir(s) offline instead "
                             "of fetching --url (repeatable)")
        fp.add_argument("--timeout", type=float, default=5.0)
        fp.add_argument("--json", action="store_true")
        if act == "trace":
            fp.add_argument("--out", default=None,
                            help="write merged Chrome JSON here instead "
                                 "of stdout")
        fp.set_defaults(fn=cmd_fleet)

    sv = sub.add_parser("serve",
                        help="inspect a live serving fleet")
    sv_sub = sv.add_subparsers(dest="action", required=True)
    sr = sv_sub.add_parser("rollout",
                           help="fleet + canary ramp status from a "
                                "process's /models endpoint")
    sr.add_argument("--url", default="http://127.0.0.1:9000",
                    help="serving process UI base URL")
    sr.add_argument("--timeout", type=float, default=5.0)
    sr.add_argument("--json", action="store_true")
    sr.set_defaults(fn=cmd_serve)
    sf = sv_sub.add_parser("fleet",
                           help="autoscaled replica pool + per-tenant "
                                "status from a process's /fleet endpoint")
    sf.add_argument("--url", default="http://127.0.0.1:9000",
                    help="serving process UI base URL")
    sf.add_argument("--timeout", type=float, default=5.0)
    sf.add_argument("--json", action="store_true")
    sf.set_defaults(fn=cmd_serve_fleet)

    sl = sub.add_parser("slo",
                        help="SLO burn-rate status (DL4J_TPU_TELEMETRY=1)")
    sl.add_argument("--interval", type=float, default=1.0,
                    help="seconds between the two samples (default 1)")
    sl.add_argument("--json", action="store_true")
    sl.set_defaults(fn=cmd_slo)

    ik = sub.add_parser("import-keras",
                        help="convert a Keras h5 model to a native zip")
    ik.add_argument("--h5", required=True, help="Keras h5 model file")
    ik.add_argument("--out", required=True, help="output model zip")
    _device_arg(ik)
    ik.set_defaults(fn=cmd_import_keras)

    # each takes its real arguments in the change that ports it; until
    # then main() lets it take any
    for name in _NOT_PORTED:
        sub.add_parser(name, help="not ported yet (exit 2)").set_defaults(
            fn=cmd_not_ported)
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args, rest = ap.parse_known_args(argv)
    if rest and args.fn is not cmd_not_ported:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
