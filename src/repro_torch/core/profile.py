"""Opt-in per-phase profiling for the simulator hot loop.

A :class:`SimProfile` accumulates wall time and call counts per named
phase (scheduling rounds, offer passes, preemption scans, re-pricing,
tuner queries, upgrade scans, rack-yield scans).  It is attached via
``ClusterSimulator(..., profile=True)`` (or by assigning
``sim.profile = SimProfile()`` before the run) and surfaces through
``results()["profile"]`` — only when enabled, so legacy artifacts stay
byte-identical.  ``benchmarks/profile_report.py`` renders it.

The instrumentation is observational only: timing never feeds back into
a scheduling decision, and with profiling off the hot loop pays a single
``is None`` check per phase.
"""
from __future__ import annotations

from typing import Dict


class SimProfile:
    """Wall-time + call-count accumulator keyed by phase name, plus
    max-keeping gauges (live event-/wait-queue depths, peak RSS)."""

    __slots__ = ("counts", "seconds", "gauges")

    def __init__(self):
        self.counts: Dict[str, int] = {}
        self.seconds: Dict[str, float] = {}
        # name -> max observed value; surfaced separately from the phase
        # timings (results()["profile_gauges"]) so the phase-dict shape —
        # and every consumer summing its wall_s values — is unchanged
        self.gauges: Dict[str, float] = {}

    def add(self, phase: str, dt: float, n: int = 1) -> None:
        self.counts[phase] = self.counts.get(phase, 0) + n
        self.seconds[phase] = self.seconds.get(phase, 0.0) + dt

    def gauge(self, name: str, value) -> None:
        """Record a level signal, keeping the maximum observed."""
        cur = self.gauges.get(name)
        if cur is None or value > cur:
            self.gauges[name] = value

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        """``{phase: {"calls": int, "wall_s": float}}``, phases sorted."""
        return {
            phase: {"calls": self.counts[phase],
                    "wall_s": self.seconds[phase]}
            for phase in sorted(self.counts)
        }

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"SimProfile({self.as_dict()!r})"
