"""Unified fault surface: one frozen spec for every way a cluster hurts.

The binary machine churn (``failure_mode``/``failure_kw``) and the
analog degradation axis (stragglers, slow NICs, flapping uplinks) plus
opt-in telemetry would otherwise sprawl across six kwargs threaded
through ``Scenario``, ``SimOverrides``, ``run_one`` and the sweep CLI.
:class:`FaultSpec` consolidates them the way ``SimOverrides``
consolidated the run knobs: a frozen dataclass with an explicit wire
form, validated at construction (a typo'd mode or knob fails fast, not
after a 40-minute cell), carried as ``Scenario.faults`` /
``SimOverrides.faults``.

The port's copy of the JAX package's ``repro.experiments.faults``, line
for line but for its imports.  The reference's legacy failure kwargs, kept
there as DeprecationWarning shims, are not ported: the port's
``Scenario`` and ``SimOverrides`` take a ``FaultSpec`` only.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Optional

from repro_torch.core.trace import resolve_degradation_kw, resolve_failure_kw


@dataclass(frozen=True)
class FaultSpec:
    """What goes wrong during a run, and whether to watch it closely.

    * ``mode``/``knobs`` — binary machine churn: ``"mtbf"`` or
      ``"maintenance"``, knobs per ``repro_torch.core.trace`` (MTBF_DEFAULTS /
      MAINTENANCE_DEFAULTS).
    * ``degradation``/``degradation_kw`` — analog performance faults:
      ``"stragglers"``, ``"slow-nics"``, ``"flapping-uplinks"`` or
      ``"mixed"``, knobs per the trace module's *_DEFAULTS.
    * ``telemetry`` — opt into the Kalos-style per-interval time-series
      artifact (``repro_torch.core.telemetry``).

    All-defaults (``FaultSpec()``) is semantically "no faults": runs are
    byte-identical to passing no spec at all.
    """

    mode: Optional[str] = None
    knobs: Mapping = field(default_factory=dict)
    degradation: Optional[str] = None
    degradation_kw: Mapping = field(default_factory=dict)
    telemetry: bool = False

    def __post_init__(self):
        # validate eagerly through the trace resolvers — unknown modes
        # and typo'd knob names must fail at construction, with the same
        # messages the schedule makers would raise mid-run
        if self.mode is not None:
            resolve_failure_kw(self.mode, dict(self.knobs))
        elif self.knobs:
            raise ValueError("FaultSpec.knobs given without a failure mode")
        if self.degradation is not None:
            resolve_degradation_kw(self.degradation,
                                   dict(self.degradation_kw))
        elif self.degradation_kw:
            raise ValueError(
                "FaultSpec.degradation_kw given without a degradation mode")

    @property
    def enabled(self) -> bool:
        """True when the spec changes anything at all."""
        return bool(self.mode or self.degradation or self.telemetry)

    # -- wire form -------------------------------------------------------
    def to_dict(self) -> dict:
        """Non-default fields only, JSON-clean (round-trips through
        :meth:`from_dict`)."""
        out: dict = {}
        if self.mode is not None:
            out["mode"] = self.mode
            if self.knobs:
                out["knobs"] = dict(self.knobs)
        if self.degradation is not None:
            out["degradation"] = self.degradation
            if self.degradation_kw:
                out["degradation_kw"] = dict(self.degradation_kw)
        if self.telemetry:
            out["telemetry"] = True
        return out

    @classmethod
    def from_dict(cls, d: Mapping) -> "FaultSpec":
        d = dict(d)
        unknown = set(d) - {"mode", "knobs", "degradation",
                            "degradation_kw", "telemetry"}
        if unknown:
            raise ValueError(
                f"unknown FaultSpec keys: {', '.join(sorted(unknown))}")
        return cls(mode=d.get("mode"), knobs=d.get("knobs") or {},
                   degradation=d.get("degradation"),
                   degradation_kw=d.get("degradation_kw") or {},
                   telemetry=bool(d.get("telemetry", False)))

    # -- override merge --------------------------------------------------
    def merged_over(self, base: Optional["FaultSpec"]) -> "FaultSpec":
        """This spec applied as an override on top of ``base``, axis-wise.

        An override that sets a failure mode replaces the base's failure
        axis wholesale — switching modes drops the base knobs (they
        belong to the other mode's schema; this preserves the documented
        "``--failures`` overrides every scenario" behaviour exactly),
        while re-stating the same mode with no knobs keeps the base's.
        The degradation axis merges by the same rule; telemetry is
        sticky-on (either side may enable it)."""
        if base is None:
            return self
        if self.mode is not None:
            mode = self.mode
            knobs = self.knobs or (base.knobs if base.mode == mode else {})
        else:
            mode, knobs = base.mode, base.knobs
        if self.degradation is not None:
            degradation = self.degradation
            degradation_kw = self.degradation_kw or (
                base.degradation_kw if base.degradation == degradation
                else {})
        else:
            degradation, degradation_kw = (base.degradation,
                                           base.degradation_kw)
        return FaultSpec(mode=mode, knobs=knobs, degradation=degradation,
                         degradation_kw=degradation_kw,
                         telemetry=self.telemetry or base.telemetry)
