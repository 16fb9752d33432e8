"""CLI entry point for the scheduler daemon.

    python -m repro_torch.service --state-dir runs/svc --inbox runs/inbox \\
        --scenario congested-spine --overrides '{"contention": "fair-share"}'

Restarting with the same --state-dir recovers from the journal and
continues; config flags must match the original run (or be omitted).
"""
from __future__ import annotations

import argparse
import json

from repro_torch.experiments.runner import SimOverrides

from .daemon import SchedulerService
from .tenancy import AdmissionPolicy


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Long-lived scheduler daemon (see docs/service.md)")
    ap.add_argument("--state-dir", required=True,
                    help="journal + snapshots + config home; reopening an "
                    "existing one recovers and continues")
    ap.add_argument("--inbox", default=None,
                    help="watched directory: drop job-spec JSON files here")
    ap.add_argument("--scenario", default=None,
                    help="registered scenario supplying the cluster/network"
                    "/failure regime (its trace is NOT submitted)")
    ap.add_argument("--policy", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--overrides", default=None,
                    help="SimOverrides as JSON, e.g. "
                    '\'{"failures": "mtbf", "n_racks": 4}\'')
    ap.add_argument("--admission", default=None,
                    help="AdmissionPolicy as JSON, e.g. "
                    '\'{"max_waiting_jobs_per_tenant": 4, '
                    '"max_waiting_gpus": 64}\' — rejected specs land in '
                    "rejected/ and are journaled as admission records")
    ap.add_argument("--stream-trace", action="store_true",
                    help="stream the scenario's trace in as background "
                    "load through a lazy TraceSource cursor (inbox stays "
                    "open; inbox job ids are offset into their own space)")
    ap.add_argument("--events-per-tick", type=int, default=200)
    ap.add_argument("--snapshot-every", type=int, default=500,
                    help="checkpoint the simulator every N stepped events")
    ap.add_argument("--tick-sleep", type=float, default=0.05,
                    help="idle backoff between ticks (real seconds)")
    ap.add_argument("--throttle", type=float, default=0.0,
                    help="sleep after EVERY tick: paces simulated time "
                    "against real time")
    ap.add_argument("--exit-when-idle", action="store_true",
                    help="finalize the artifact and exit once the inbox "
                    "and the event queue are both drained")
    ap.add_argument("--max-ticks", type=int, default=None,
                    help="stop after N ticks (smoke tests)")
    args = ap.parse_args(argv)

    overrides = (SimOverrides.from_dict(json.loads(args.overrides))
                 if args.overrides else None)
    admission = (AdmissionPolicy.from_dict(json.loads(args.admission))
                 if args.admission else None)
    svc = SchedulerService(
        args.state_dir, scenario=args.scenario, policy=args.policy,
        seed=args.seed, overrides=overrides, inbox=args.inbox,
        events_per_tick=args.events_per_tick,
        snapshot_every=args.snapshot_every,
        stream_trace=args.stream_trace, admission=admission)
    with svc:
        art = svc.serve(tick_sleep=args.tick_sleep, throttle=args.throttle,
                        exit_when_idle=args.exit_when_idle,
                        max_ticks=args.max_ticks)
    if art is not None:
        m = art["metrics"]
        print(f"final artifact: {svc.state_dir / 'artifact.json'} "
              f"(n_finished={m['n_finished']} makespan={m['makespan']:.0f}s)")


if __name__ == "__main__":
    main()
