"""CLI entry point: ``python -m ray_tpu_torch <command>`` (port of
``ray_tpu/__main__.py``).

Analog of the reference's ``ray`` CLI (python/ray/scripts/scripts.py:
``ray start`` :571, ``ray stop`` :1047, ``ray job submit/status/logs/
stop/list``, ``ray list tasks|actors|nodes``). Commands:

    head    start a head process (client server + dashboard), park
    start   join this machine to a running head as a node daemon
    submit  submit a job entrypoint to a head's dashboard
    job     status|logs|stop|list against a dashboard address
    list    tasks|actors|nodes|objects|placement_groups via dashboard
    memory  cluster memory/object ownership table (`ray memory` analog)
    timeline  merged Perfetto trace / step-time attribution report
    goodput   goodput fraction + badput ledger + detector state
    xla       the program observatory's cluster-wide fold (/api/xla)
    stack     cluster-wide collapsed-stack dump (wedged-gang companion)
    up|down|cluster-status   the cluster launcher (cluster_launcher.py)

``lint`` is not a command here: graftlint stays the JAX package's tool
(``ray_tpu/tools/lint``; its ``--root ray_tpu_torch`` scans this
package).
"""

from __future__ import annotations

import argparse
import json
import shlex
import sys
import time


def _cmd_head(args) -> int:
    import ray_tpu_torch
    from ray_tpu_torch.dashboard import start_dashboard

    ray_tpu_torch.init(num_cpus=args.num_cpus, num_gpus=args.num_gpus)
    addr, key = ray_tpu_torch.start_client_server(host=args.host, port=args.port)
    dash = start_dashboard(host=args.host, port=args.dashboard_port)
    from ray_tpu_torch.core import api as _api

    head = _api._get_head()
    print("head started.")
    print(f"  client address : ray_tpu://{addr[0]}:{addr[1]}")
    print(f"  cluster key    : {key}")
    print(f"  dashboard      : http://{dash.address[0]}:{dash.address[1]}")
    if dash.auth_token:
        print(f"  job auth token : {dash.auth_token} "
              "(pass --token / RAY_TPU_JOB_TOKEN to submit)")
    if getattr(head, "node_server_address", None):
        ns = head.node_server_address
        print(f"  node server    : {ns[0]}:{ns[1]} (for `start --address`)")
    # flushed: a supervisor reading a pipe learns the addresses now
    print("Ctrl-C to stop.", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        ray_tpu_torch.shutdown()
    return 0


def _cmd_submit(args, rest) -> int:
    from ray_tpu_torch.jobs import JobSubmissionClient

    client = JobSubmissionClient(args.address, auth_token=args.token)
    # shlex.join preserves the caller's quoting through the server-side
    # shell re-execution
    entrypoint = shlex.join(rest) if rest else args.entrypoint
    if not entrypoint:
        print("no entrypoint given (use: submit -- <cmd ...>)",
              file=sys.stderr)
        return 2
    runtime_env = {}
    if args.working_dir:
        runtime_env["working_dir"] = args.working_dir
    sid = client.submit_job(entrypoint=entrypoint,
                            runtime_env=runtime_env or None,
                            submission_id=args.submission_id)
    print(sid)
    if args.no_wait:
        return 0
    for chunk in client.tail_job_logs(sid):
        sys.stdout.write(chunk)
        sys.stdout.flush()
    status = client.get_job_status(sid)
    print(f"\njob {sid}: {status}", file=sys.stderr)
    return 0 if status == "SUCCEEDED" else 1


def _cmd_job(args) -> int:
    from ray_tpu_torch.jobs import JobSubmissionClient

    client = JobSubmissionClient(args.address, auth_token=args.token)
    if args.op == "list":
        print(json.dumps(client.list_jobs(), indent=2))
    elif args.op == "status":
        print(client.get_job_status(args.job_id))
    elif args.op == "logs":
        sys.stdout.write(client.get_job_logs(args.job_id))
    elif args.op == "stop":
        print(json.dumps({"stopped": client.stop_job(args.job_id)}))
    return 0


def _cmd_list(args) -> int:
    import urllib.request

    base = args.address
    if not base.startswith("http"):
        base = "http://" + base
    url = f"{base}/api/{args.kind}?limit={args.limit}"
    with urllib.request.urlopen(url, timeout=10) as resp:
        print(json.dumps(json.loads(resp.read().decode()), indent=2))
    return 0


def _cmd_memory(args) -> int:
    """Render the cluster memory table from the dashboard /api/memory —
    the same grouped numbers util.state.memory_summary returns."""
    import urllib.request

    base = args.address
    if not base.startswith("http"):
        base = "http://" + base
    url = f"{base}/api/memory?group_by={args.group_by}&limit={args.limit}"
    with urllib.request.urlopen(url, timeout=30) as resp:
        data = json.loads(resp.read().decode())
    if "error" in data:
        print(data["error"], file=sys.stderr)
        return 1
    groups = data.get("groups", [])
    totals = data.get("totals", {})
    col = {"callsite": "CALLSITE", "node": "NODE",
           "task": "TASK"}.get(args.group_by, args.group_by.upper())
    widths = max([len(col)] + [len(str(g["group"])) for g in groups])
    header = (f"{col:<{widths}}  {'OBJECTS':>8}  {'BYTES':>14}  "
              f"{'LOCAL':>6}  {'BORROW':>6}  {'PINNED':>6}  {'SPILLED':>7}")
    print(header)
    print("-" * len(header))
    for g in groups:
        print(f"{str(g['group']):<{widths}}  {g['objects']:>8}  "
              f"{g['bytes']:>14}  {g['local_refs']:>6}  {g['borrows']:>6}  "
              f"{g['pinned']:>6}  {g['spilled_objects']:>7}")
    print("-" * len(header))
    print(f"total: {totals.get('objects', 0)} objects, "
          f"{totals.get('bytes', 0)} bytes "
          f"(inline {totals.get('inline_bytes', 0)}, "
          f"arena {totals.get('arena_bytes', 0)}, "
          f"spilled {totals.get('spilled_bytes', 0)})")
    return 0


def _cmd_timeline(args) -> int:
    """Fetch (or load) a merged cluster trace; write Perfetto JSON
    and/or print the where-did-my-step-time-go attribution report."""
    from ray_tpu_torch.util.flight_recorder import (attribute_trace,
                                              format_attribution)

    if args.input:
        with open(args.input) as f:
            events = json.load(f)
    else:
        import urllib.request

        base = args.address
        if not base.startswith("http"):
            base = "http://" + base
        with urllib.request.urlopen(f"{base}/api/timeline",
                                    timeout=30) as resp:
            events = json.loads(resp.read().decode())
    if isinstance(events, dict):
        # both Chrome-trace shapes are valid: bare event list or
        # {"traceEvents": [...]} (what a --perfetto re-export or an
        # object-format dump carries)
        events = events.get("traceEvents", [])
    if args.perfetto:
        with open(args.perfetto, "w") as f:
            json.dump(events, f)
        print(f"wrote {len(events)} events to {args.perfetto} "
              "(open in https://ui.perfetto.dev)")
    if args.attribute or not args.perfetto:
        print(format_attribution(attribute_trace(events)))
    if args.goodput:
        # the badput-ledger view over the SAME fetched trace (no
        # cluster events client-side: recovery gaps need /api/goodput)
        from ray_tpu_torch.util.goodput import classify_badput, format_goodput

        print(format_goodput(classify_badput(events)))
    return 0


def _cmd_goodput(args) -> int:
    """Render the goodput observatory report from /api/goodput."""
    import urllib.request

    from ray_tpu_torch.util.goodput import format_goodput

    base = args.address
    if not base.startswith("http"):
        base = "http://" + base
    with urllib.request.urlopen(f"{base}/api/goodput", timeout=30) as resp:
        ledger = json.loads(resp.read().decode())
    if args.json:
        print(json.dumps(ledger, indent=2))
    else:
        print(format_goodput(ledger))
    return 0


def _cmd_xla(args) -> int:
    """Render the program observatory's cluster-wide fold from /api/xla."""
    import urllib.request

    from ray_tpu_torch.util.program_observatory import format_programs

    base = args.address
    if not base.startswith("http"):
        base = "http://" + base
    with urllib.request.urlopen(f"{base}/api/xla", timeout=30) as resp:
        report = json.loads(resp.read().decode())
    if args.program:
        progs = report.get("programs", {})
        rec = progs.get(args.program)
        if rec is None:
            print(f"no program {args.program!r} in the registry "
                  f"(known: {', '.join(sorted(progs)) or 'none'})",
                  file=sys.stderr)
            return 1
        print(json.dumps({args.program: rec}, indent=2))
        return 0
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        print(format_programs(report))
    return 0


def _cmd_stack(args) -> int:
    """Cluster-wide collapsed-stack dump from /api/stacks: one bounded
    sampling round per process, printed per-process (or merged with
    --merge for one flamegraph input)."""
    import urllib.request

    base = args.address
    if not base.startswith("http"):
        base = "http://" + base
    url = f"{base}/api/stacks"
    if args.duration_ms:
        url += f"?duration_ms={args.duration_ms}"
    with urllib.request.urlopen(url, timeout=60) as resp:
        stacks = json.loads(resp.read().decode())
    if args.merge:
        for source in sorted(stacks):
            for line in stacks[source].splitlines():
                print(f"{source};{line}")
        return 0
    for source in sorted(stacks):
        print(f"==> {source} <==")
        print(stacks[source] or "(no samples)")
        print()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch",
        epilog="lint is not ported: graftlint stays the JAX package's "
               "tool (ray_tpu/tools/lint, with --root ray_tpu_torch)")
    sub = p.add_subparsers(dest="cmd")

    h = sub.add_parser("head", help="start a head (client server + dashboard)")
    h.add_argument("--host", default="0.0.0.0",
                   help="bind interface (default all; use 127.0.0.1 for "
                        "local-only)")
    h.add_argument("--port", type=int, default=0)
    h.add_argument("--dashboard-port", type=int, default=8265)
    h.add_argument("--num-cpus", type=int, default=None)
    h.add_argument("--num-gpus", type=int, default=None,
                   help="GPUs the head advertises (default: the cards "
                        "visible to it)")

    # NOTE: `start` is dispatched before argparse (see main()); this
    # stub exists only so it shows in --help
    sub.add_parser("start", help="join a head as a node daemon "
                                 "(--address <host:port> --key <hex> "
                                 "--num-gpus N ...)")

    sb = sub.add_parser("submit", help="submit a job")
    sb.add_argument("--address", default="http://127.0.0.1:8265")
    sb.add_argument("--working-dir", default=None)
    sb.add_argument("--submission-id", default=None)
    sb.add_argument("--no-wait", action="store_true")
    sb.add_argument("--entrypoint", default=None)
    sb.add_argument("--token", default=None,
                    help="job auth token (or RAY_TPU_JOB_TOKEN)")

    j = sub.add_parser("job", help="job status|logs|stop|list")
    j.add_argument("op", choices=["status", "logs", "stop", "list"])
    j.add_argument("job_id", nargs="?")
    j.add_argument("--address", default="http://127.0.0.1:8265")
    j.add_argument("--token", default=None)

    ls = sub.add_parser("list", help="list cluster state")
    ls.add_argument("kind", choices=["tasks", "actors", "nodes", "objects",
                                     "placement_groups", "jobs"])
    ls.add_argument("--address", default="http://127.0.0.1:8265")
    ls.add_argument("--limit", type=int, default=100)

    mem = sub.add_parser("memory",
                         help="cluster memory/object ownership table")
    mem.add_argument("--address", default="http://127.0.0.1:8265")
    mem.add_argument("--group-by", choices=["callsite", "node", "task"],
                     default="callsite", dest="group_by")
    mem.add_argument("--limit", type=int, default=50)

    tl = sub.add_parser("timeline",
                        help="merged cluster trace (flight recorder + "
                             "task slices): --perfetto out.json writes "
                             "Chrome/Perfetto JSON, --attribute prints "
                             "the per-step time budget")
    tl.add_argument("--address", default="http://127.0.0.1:8265",
                    help="dashboard address serving /api/timeline")
    tl.add_argument("--input", default=None,
                    help="read a previously exported trace JSON instead "
                         "of fetching from a dashboard")
    tl.add_argument("--perfetto", default=None, metavar="OUT_JSON",
                    help="write the merged trace to this file")
    tl.add_argument("--attribute", action="store_true",
                    help="print the step-time attribution report")
    tl.add_argument("--goodput", action="store_true",
                    help="also print the badput-ledger view of the "
                         "same trace (full report: `goodput`)")

    gp = sub.add_parser("goodput",
                        help="goodput fraction + badput breakdown + "
                             "straggler/regression/TTRT detector state")
    gp.add_argument("--address", default="http://127.0.0.1:8265",
                    help="dashboard address serving /api/goodput")
    gp.add_argument("--json", action="store_true",
                    help="print the raw ledger JSON")

    xl = sub.add_parser("xla",
                        help="program observatory, cluster-wide: "
                             "per-program first calls/recompiles, "
                             "FLOPs, roofline verdict, MFU on the card")
    xl.add_argument("--address", default="http://127.0.0.1:8265",
                    help="dashboard address serving /api/xla")
    xl.add_argument("--json", action="store_true",
                    help="print the raw report JSON")
    xl.add_argument("--program", default=None, metavar="NAME",
                    help="print one program's full record (avals, "
                         "memory, kernels, churn) as JSON")

    st = sub.add_parser("stack",
                        help="cluster-wide collapsed-stack dump (one "
                             "bounded sample round per process)")
    st.add_argument("--address", default="http://127.0.0.1:8265",
                    help="dashboard address serving /api/stacks")
    st.add_argument("--duration-ms", type=int, default=0,
                    dest="duration_ms",
                    help="per-process sample duration (default: the "
                         "stack_dump_duration_ms Config knob)")
    st.add_argument("--merge", action="store_true",
                    help="prefix every line with its process and merge "
                         "into one collapsed stream (flamegraph input)")

    up = sub.add_parser("up", help="launch a cluster from a YAML spec")
    up.add_argument("config", help="cluster YAML path")
    dn = sub.add_parser("down", help="tear down a launched cluster")
    dn.add_argument("config")
    cs = sub.add_parser("cluster-status", help="status of a launched cluster")
    cs.add_argument("config")

    argv = list(sys.argv[1:] if argv is None else argv)
    # `start` hands everything through to the daemon parser directly
    # (argparse REMAINDER chokes on a leading --flag)
    if argv and argv[0] == "start":
        from ray_tpu_torch.core.node_daemon import main as daemon_main

        return daemon_main(argv[1:])
    # split off trailing "-- entrypoint..." for submit
    rest = []
    if "--" in argv:
        i = argv.index("--")
        argv, rest = argv[:i], argv[i + 1:]
    args = p.parse_args(argv)

    if args.cmd == "head":
        return _cmd_head(args)
    if args.cmd == "submit":
        return _cmd_submit(args, rest)
    if args.cmd == "job":
        if args.op != "list" and not args.job_id:
            print("job_id required", file=sys.stderr)
            return 2
        return _cmd_job(args)
    if args.cmd == "list":
        if args.kind == "jobs":
            args.kind = "jobs/"
        return _cmd_list(args)
    if args.cmd == "memory":
        return _cmd_memory(args)
    if args.cmd == "timeline":
        return _cmd_timeline(args)
    if args.cmd == "goodput":
        return _cmd_goodput(args)
    if args.cmd == "xla":
        return _cmd_xla(args)
    if args.cmd == "stack":
        return _cmd_stack(args)
    if args.cmd == "up":
        from ray_tpu_torch.cluster_launcher import up as _up

        _up(args.config)
        return 0
    if args.cmd == "down":
        from ray_tpu_torch.cluster_launcher import down as _down

        return 0 if _down(args.config) else 1
    if args.cmd == "cluster-status":
        from ray_tpu_torch.cluster_launcher import status as _status

        try:
            print(json.dumps(_status(args.config), indent=2))
        except BrokenPipeError:  # `| head` closed the pipe
            pass
        return 0
    p.print_help()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
