"""Kalos-style per-interval cluster telemetry (opt-in).

Large-scale trace studies (Hu et al., arXiv 2109.01313) characterize GPU
datacenters through per-interval time-series: per-machine utilization and
throughput, per-link effective bandwidth.  This module is the simulator's
equivalent: when enabled (``ClusterSimulator(telemetry=True)``), a
:class:`Telemetry` collector samples at every ROUND tick — the same
cadence as the aggregate :class:`~repro_torch.core.metrics.Timeline` — so the
per-machine busy series sums exactly to the timeline's busy-GPU series
and its mean reproduces ``avg_utilization()`` bit-for-bit.

The collector is pure recorded state (no hooks, no callbacks), so it
pickles through the service's crash-recovery snapshots unchanged, and it
is entirely absent unless requested — legacy artifacts are untouched.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

TELEMETRY_SCHEMA = "repro.core.telemetry/v1"


def link_key(link) -> str:
    """Stable JSON-safe name for a fabric link: ("uplink", 3) ->
    "uplink:3", the spine sentinel -> "spine"."""
    if len(link) == 1:
        return link[0]
    return ":".join(str(p) for p in link)


class Telemetry:
    """Per-interval time-series collector.

    ``machines`` is the (sorted) list of GPU-holding machine ids — hetero
    topologies' ghost stride slots are excluded.  Each sample records, per
    machine, the allocated GPUs (``busy_gpus``) and the aggregate
    iteration throughput of the jobs running there (``throughput``,
    iterations/second, each job's rate split across its machines by GPU
    share), plus each fabric link's current effective bandwidth when a
    shared fabric is modelled.
    """

    def __init__(self, machines: Sequence[int],
                 link_names: Sequence[str] = ()):
        self.machines: List[int] = list(machines)
        self.link_names: List[str] = list(link_names)
        self.t: List[float] = []
        self.busy_gpus: List[List[int]] = []
        self.throughput: List[List[float]] = []
        self.link_bw: Dict[str, List[float]] = {n: []
                                                for n in self.link_names}

    def record(self, t: float, busy: List[int], rate: List[float],
               link_bw: Dict[str, float]) -> None:
        self.t.append(t)
        self.busy_gpus.append(busy)
        self.throughput.append(rate)
        for name in self.link_names:
            self.link_bw[name].append(link_bw[name])

    def latest(self) -> dict:
        """The most recent sample (live observability), {} before any."""
        if not self.t:
            return {}
        return {
            "t": self.t[-1],
            "busy_gpus": dict(zip(self.machines, self.busy_gpus[-1])),
            "throughput_iters_per_s": dict(zip(self.machines,
                                               self.throughput[-1])),
            "link_bw": {n: s[-1] for n, s in self.link_bw.items()},
        }

    def as_dict(self) -> dict:
        """Wire form for artifacts (columnar: one row per sample)."""
        return {
            "schema": TELEMETRY_SCHEMA,
            "machines": list(self.machines),
            "links": list(self.link_names),
            "t": list(self.t),
            "busy_gpus": [list(r) for r in self.busy_gpus],
            "throughput_iters_per_s": [list(r) for r in self.throughput],
            "link_bw": {n: list(s) for n, s in self.link_bw.items()},
        }
