"""Scheduler policy interface.

The simulator calls, each scheduling round:
  priority(job, now)         — lower value = served first (offers + GPUs)
  on_offer(job, sim, now)    — the job's *local scheduler*: given current
                               availability, return the consolidation level
                               to accept ("machine"|"rack"|"network") or None
                               to keep waiting
  wants_preemption(...)      — whether a waiting job may evict running ones
  on_round(sim, now)         — optional per-round hook (e.g. migration)
"""
from __future__ import annotations


class Policy:
    name = "base"
    preemption_enabled = True
    # minimum priority-value gap (in the policy's own priority units) between
    # a running victim and the waiting job before eviction is allowed
    preemption_margin = 0.3
    # Contract: priority(job, now) does not change while the job sits in the
    # wait queue (it may change while running).  True for every built-in
    # policy (Nw_sens / 2DAS freeze without progress; FIFO is constant), and
    # it lets the simulator keep the wait queue sorted incrementally instead
    # of re-sorting every round.  Set False in subclasses whose waiting
    # priority depends on `now` (e.g. pure starvation-age priority).
    waiting_priority_static = True

    def priority(self, job, now: float) -> float:
        raise NotImplementedError

    def priority_many(self, jobs, now: float):
        """Vectorized batch twin of :meth:`priority`: an array of the
        exact same values for ``jobs``, or None when the policy has no
        vectorized implementation (the simulator then falls back to the
        scalar scan).  Implementations must be bit-identical to the
        scalar method — the values feed preemption decisions."""
        return None

    def on_offer(self, job, sim, now: float):
        raise NotImplementedError

    def offer_held(self, job, sim, now: float) -> bool:
        """Offer-hold protocol: an :meth:`on_offer` that returns None may
        set ``job._offer_hold``; the simulator's offer pass then checks
        the hold before every re-offer and skips the on_offer call while
        it provably still stands.  The contract is strict decision
        identity: a hold may only be honored when on_offer would
        *provably* return None again at this ``now`` — live capacity
        facts are re-checked and the frozen timer's starvation comparison
        is repeated verbatim (never a precomputed crossing *time*: a
        ``wait + timer`` float add could round past the comparison
        on_offer would actually make).  This is the biggest call-count
        sink at datacenter scale — a deep wait queue re-rejects thousands
        of jobs per round while their delay timers run.

        The hold is the STANDARDIZED tuple
        ``((valid_until, dep), timer, is_rack)``:

        * ``valid_until`` — last instant the frozen timer value is
          unchanged absent new observations (aging bound; +inf for
          fixed timers),
        * ``dep`` — ``(version_dict, key, seen)`` observation stamp that
          moves exactly when the timer can change, or None,
        * ``timer`` — the frozen (plan-scaled) timer value the rejection
          compared starvation against,
        * ``is_rack`` — True for a rack-timer rejection (adds the
          rack-capacity live checks), False for a machine-timer one.

        A hold stands iff: ``now <= valid_until``, the dep stamp is
        unmoved, no whole machine opened up (``max_free_on_machine < g``;
        for rack holds additionally ``max_free_on_rack < g`` and
        ``g <= max_rack_capacity``), and ``starvation(now) < timer`` —
        the exact comparison the rejecting branch would repeat.

        This method is the REFERENCE implementation; the simulator's
        offer pass inlines the identical logic (no per-job call), and
        the identity suites pin the two against each other.  The
        simulator clears the hold on every re-enqueue."""
        (vu, dep), limit, is_rack = job._offer_hold
        if now > vu or (dep is not None
                        and dep[0].get(dep[1], 0) != dep[2]):
            return False
        cl = sim.cluster
        g = job.n_gpus
        if cl.max_free_on_machine() >= g:
            # a whole machine opened up: on_offer would accept (machine
            # holds are only stamped on machine-fitting jobs) or, for a
            # rack hold, at least needs the full branch walk again
            return False
        if is_rack and (cl.max_free_on_rack() >= g
                        or g > cl.max_rack_capacity):
            return False
        # the exact comparison the rejecting branch would repeat
        return job.starvation(now) < limit

    def on_round(self, sim, now: float):
        return

    def record_acceptance(self, job, tier: str, now: float):
        """Called after a job accepts an offer (auto-tuner hook)."""
        return

    def note_place(self, job, sim):
        """Called by the simulator right after ``job``'s placement is
        live (fields like ``placement_tier`` / ``exposed_comm_per_iter``
        set) — the seam policies use to maintain incremental candidate
        indices (e.g. Dally's rack-yield victim index).  Must not mutate
        the simulation."""
        return

    def note_evict(self, job, sim):
        """Counterpart of :meth:`note_place`, called while ``job``'s
        placement is still set, just before teardown (preemption, crash,
        or completion)."""
        return
