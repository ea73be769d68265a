"""``simulate serve``: run the port's twin as a persistent service (a copy
of ``repro.serve.cli`` with ``--device``).

    python -m repro_torch.launch.simulate serve --listen unix:/tmp/twin.sock \\
        --system frontier --jobs 1238 -t 2h --interval-steps 60

The session runs on the card unless ``--device cpu`` is given. Prints one
JSON line ``{"serving": "<bound address>", ...}`` to stdout once the
socket is listening (with ``--listen host:0`` the line carries the
kernel-assigned port), then blocks until a client sends ``shutdown`` or
``--max-seconds`` elapses, and prints a final ``{"served": ...}`` line.
Talk to it with the stdlib client::

    python -m tools.twin_client --connect unix:/tmp/twin.sock \\
        --script "advance 0 3; fork 0 setpoint_delta_c=2.0; state; shutdown"

Protocol and failure model: docs/serving.md.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.core import types as T
from repro_torch.datasets import loaders
from repro_torch.serve.server import TwinServer
from repro_torch.serve.session import TwinSession


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="simulate serve", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--listen", default="127.0.0.1:0",
                    help="bind address: unix:/path or host:port "
                         "(port 0 = kernel-assigned, reported on stdout)")
    ap.add_argument("--system", default="marconi100")
    ap.add_argument("--scale", type=int, default=0,
                    help="scale the system to N nodes (CPU-friendly)")
    ap.add_argument("--halls", type=int, default=0,
                    help="split the cooling plant into N halls")
    ap.add_argument("--jobs", type=int, default=1000)
    ap.add_argument("--days", type=float, default=None,
                    help="dataset horizon to generate (days)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("-ff", "--fastforward", default="0", type=str,
                    help="simulation start offset (s/m/h/d suffix)")
    ap.add_argument("-t", "--time", default="6h", type=str,
                    help="served horizon (simulated duration)")
    ap.add_argument("--interval-steps", type=int, default=8,
                    help="engine steps per interval: the checkpoint/"
                         "advance granularity of the session")
    ap.add_argument("--policy", default="fcfs",
                    help="root-branch scheduling policy")
    ap.add_argument("--backfill", default="none")
    ap.add_argument("--batch-window", type=float, default=0.01,
                    help="seconds the executor waits so concurrent "
                         "advances coalesce into one batched sweep")
    ap.add_argument("--client-timeout", type=float, default=60.0,
                    help="per-connection read timeout (s); a hung "
                         "client is dropped after this long")
    ap.add_argument("--obs-dir", default=None, metavar="DIR",
                    help="write a per-session run manifest + NDJSON "
                         "event log under DIR")
    ap.add_argument("--max-seconds", type=float, default=None,
                    help="exit after this long even without a shutdown "
                         "request (CI guard)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the session (default cuda; cpu "
                         "only on request)")
    args = ap.parse_args(argv)

    from repro_torch.launch.simulate import _parse_time, build_system
    sys_ = build_system(args.system, args.scale, args.halls)
    if args.interval_steps < 1:
        ap.error(f"--interval-steps must be >= 1, got "
                 f"{args.interval_steps}")
    t0 = _parse_time(args.fastforward)
    # advances land on interval boundaries, so the session rejects a
    # horizon with a trailing partial interval — round the requested
    # duration down to a whole number of intervals (the effective
    # horizon_steps is reported in the startup line and every hello)
    steps = int(round(_parse_time(args.time) / sys_.dt))
    steps -= steps % args.interval_steps
    if steps < args.interval_steps:
        ap.error(f"-t {args.time} is shorter than one interval "
                 f"({args.interval_steps} steps x {sys_.dt:g}s)")
    t1 = t0 + steps * float(sys_.dt)
    days = args.days or max((t1 / 86400.0) * 1.25, 0.5)
    js = loaders.load(args.system, n_jobs=args.jobs, days=days,
                      seed=args.seed)
    js.assign_prepop_placement(t0, sys_.n_nodes)
    table = js.to_table()
    scen = T.Scenario.make(args.policy, args.backfill)

    session = TwinSession(sys_, table, scen, t0, t1,
                          interval_steps=args.interval_steps,
                          device=args.device)
    server = TwinServer(session, args.listen, jobs=js,
                        batch_window_s=args.batch_window,
                        obs_dir=args.obs_dir,
                        client_timeout_s=args.client_timeout)
    print(json.dumps({"serving": server.address,
                      "system": sys_.name, "n_nodes": int(sys_.n_nodes),
                      "horizon_steps": session.horizon_steps,
                      "interval_steps": session.interval_steps}),
          flush=True)
    try:
        server.wait(args.max_seconds)
    except KeyboardInterrupt:
        pass
    stats = server.close()
    print(json.dumps({"served": stats["n_clients"],
                      "wire": stats["wire"],
                      "session": stats["session"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
