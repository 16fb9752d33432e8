"""Dally (paper §IV-B): delay scheduling (Algo 1) + Nw_sens preemption
priority + auto-tuned delay timers (Algo 2).

Under a shared fabric (endogenous cross-job contention) Nw_sens reacts to
*live* congestion with no extra machinery: fair-share re-pricing slows a
contended job's iteration progress, which lowers its W_compl/T_norm ratio,
which moves it to the front of the offer/upgrade order — so the policy
automatically favors exactly the jobs the fabric is currently throttling."""
from __future__ import annotations

import math
from time import perf_counter

from repro_torch.core.autotuner import AutoTuner
from repro_torch.core.job import (
    DEFAULT_PRIORITY,
    PRIORITY_MULT,
    nw_sens_many,
    priority_mults_many,
)

from .base import Policy

# below this many upgrade candidates the scalar nw_sens sort beats numpy's
# array-construction overhead; a pure performance knob — both orderings are
# identical (stable ascending sort over bit-identical scores)
_VEC_MIN_SCORE = 128


class DallyPolicy(Policy):
    name = "dally"

    def __init__(self, history_time_limit: float = 7 * 24 * 3600.0,
                 default_machine: float = 12 * 3600.0,
                 default_rack: float = 12 * 3600.0):
        self.tuner = AutoTuner(history_time_limit=history_time_limit,
                               default_machine=default_machine,
                               default_rack=default_rack)
        # per-demand memo of the last (now, tuner.version) timer pair: an
        # offer pass queries the same handful of demands for hundreds of
        # waiting jobs at one `now`, and the value can only change when
        # the tuner records a new observation (version bump) or the clock
        # moves.  Replaying the memo is exact: a repeat call at equal
        # (now, version) returns the identical value, and its only state
        # effects (bucket creation, pruning to `now`, cache writes) were
        # already applied by the first call, so skipping it leaves the
        # tuner bit-identical too.
        self._timer_memo = {}
        # rack -> {job_id: running tolerant job}: the incremental
        # rack-yield victim index (see note_place / _tolerant_buckets_*)
        self._tolerant_by_rack = {}

    # resource offers go out in increasing Nw_sens (most starved first);
    # the priority-class multiplier inflates a low-priority job's score
    # (served later, evicted sooner) and deflates a high-priority one.
    # Guarded so default-class populations stay bit-identical.
    def priority(self, job, now):
        v = job.nw_sens(now)
        if job.priority != DEFAULT_PRIORITY:
            v *= PRIORITY_MULT[job.priority]
        return v

    def priority_many(self, jobs, now):
        out = nw_sens_many(jobs, now)
        if out is None:
            return None
        mults = priority_mults_many(jobs)
        if mults is not None:
            # default-class entries multiply by exactly 1.0 — a bitwise
            # no-op, so this matches the guarded scalar path per element
            out = out * mults
        return out

    def _timers(self, job, sim, now):
        # a job that cannot fit a machine/rack has the respective timer at
        # 0 — don't even query the tuner for that tier (such jobs are never
        # accepted there, so the bucket is forever empty and every query
        # would recompute the tier-wide fallback aggregate for nothing)
        g = job.n_gpus
        tuner = self.tuner
        memo = self._timer_memo.get(g)
        if (memo is not None and memo[0] == now
                and memo[1] == tuner.version):
            return memo[2]
        prof = sim.profile
        t0 = perf_counter() if prof is not None else 0.0
        n_queries = 0
        if g <= sim.cluster.gpus_per_machine:
            t_mc, vu_mc, dep_mc = tuner.timer_and_horizon(
                "machine", g, now)
            n_queries += 1
        else:
            t_mc, vu_mc, dep_mc = 0.0, math.inf, None
        if g <= sim.cluster.max_rack_capacity:
            t_rk, vu_rk, dep_rk = tuner.timer_and_horizon("rack", g, now)
            n_queries += 1
        else:
            t_rk, vu_rk, dep_rk = 0.0, math.inf, None
        if prof is not None:
            prof.add("tuner_query", perf_counter() - t0, n=n_queries)
        out = (t_mc, t_rk, (vu_mc, dep_mc), (vu_rk, dep_rk))
        self._timer_memo[g] = (now, tuner.version, out)
        return out

    # Pattern-aware tier preference: the delay timers scale with the plan's
    # traffic mix (ParallelPlan.delay_scales).  A PP-heavy job (rack scale
    # -> 0) takes whatever tier is offered — its stage-boundary point-to-
    # point traffic tolerates cross-rack placement, so it yields the
    # rack-local slots; an EP-heavy job (scale -> 2) waits longer for
    # consolidation, because its expert all-to-all is hyper-sensitive to
    # it; a TP job keeps a high machine scale (a spilled TP group pays its
    # full activation volume at the worst tier).  Plan-less jobs scale by
    # exactly (1.0, 1.0) — the legacy behaviour, bit-for-bit.
    def _plan_timer_scales(self, job):
        return (1.0, 1.0) if job.plan is None else job.plan.delay_scales()

    # offer_held: inherited — DallyPolicy stamps the standardized hold
    # tuple (see Policy.offer_held), so the base reference predicate and
    # the simulator's inlined twin both apply unchanged.

    # Algorithm 1: On Resource Offer
    def on_offer(self, job, sim, now):
        cl = sim.cluster
        g = job.n_gpus
        t_starv = job.starvation(now)
        t_mc, t_rk, h_mc, h_rk = self._timers(job, sim, now)
        s_mc, s_rk = self._plan_timer_scales(job)
        if (s_mc, s_rk) != (1.0, 1.0):
            # 0.0 * inf would be nan: a zero scale means "never wait"
            t_mc = t_mc * s_mc if s_mc > 0.0 else 0.0
            t_rk = t_rk * s_rk if s_rk > 0.0 else 0.0

        # explicit capacity guards: a tier that can NEVER hold the job must
        # not be granted (or waited for), independent of the timer values —
        # previously only the _timers zeroing protected this implicitly
        fits_machine = g <= cl.gpus_per_machine
        fits_rack = g <= cl.max_rack_capacity

        if fits_machine and cl.max_free_on_machine() >= g:
            return "machine"
        if fits_machine and t_starv < t_mc:
            # timer reject: stamp an offer hold — this branch rejects
            # again while no machine opens up (live check in offer_held),
            # t_mc's tuner dependency is untouched and hasn't aged out,
            # and starvation is still under the (scaled) timer
            job._offer_hold = (h_mc, t_mc, False)
            return None  # reject: keep waiting for a machine-level offer
        if fits_rack and cl.max_free_on_rack() >= g:
            return "rack"
        if fits_rack and t_starv < t_rk:
            # sound whatever the machine timer does meanwhile: a bigger
            # t_mc re-rejects at the machine branch (still None), a
            # smaller one falls through to this branch again — only t_rk
            # (frozen through its own dep) and the live capacity gates
            # matter
            job._offer_hold = (h_rk, t_rk, True)
            return None  # reject: keep waiting for a rack-level offer
        if cl.free_gpus() >= g:
            return "network"
        # no hold: the offer pass only probes jobs with free >= n_gpus,
        # so this branch is unreachable from it — nothing to amortize
        return None  # nothing to allocate at all

    def record_acceptance(self, job, tier, now):
        if tier in ("machine", "rack"):
            self.tuner.update_demand_delay(tier, job.starvation(now),
                                           job.n_gpus, now)

    # Network-sensitive consolidation upgrades (paper §VI-3): jobs with low
    # Nw_sens — i.e. suffering from a sub-optimal placement — receive the
    # most favorable offers, including migration of *running* jobs to a
    # strictly better tier when one becomes reachable.
    upgrades_per_round = 4
    upgrade_min_runtime = 900.0
    # pattern-aware slot yielding: per round, at most this many waiting
    # tier-sensitive (EP-heavy) jobs may claim a rack by displacing
    # tier-tolerant (PP-heavy) running jobs to the network tier
    yields_per_round = 2
    # rack-scale above which a waiting job is worth displacing others
    # for — 1.8 admits only EP-dominated plans (scale -> 2.0), whose
    # all-to-all gains the most from a rack slot; mixed DP+EP plans gain
    # too little to justify the displaced jobs' restart churn
    SENSITIVE_RACK_SCALE = 1.8

    def _rack_scale(self, job):
        return (self._plan_timer_scales(job)[1]
                if job.plan is not None else 1.0)

    def _runs_cheap(self, job):
        """True when the job's live placement exposes negligible comm —
        tolerant in *fact*, not just by plan.  A displaced TP job whose
        groups landed split across machines is NOT cheap (its activation
        all-gather spilled to the worst tier) and must stay eligible for
        upgrades and ineligible as a yield victim."""
        return (getattr(job, "exposed_comm_per_iter", 0.0)
                <= 0.25 * job.compute_time_per_iter)

    # -- incremental rack-yield victim index --------------------------------
    # Membership in the tolerant-victim buckets is static for the lifetime
    # of a placement: _rack_scale is a pure function of the (immutable)
    # plan, single-rack-ness is pinned by placement_tier, and
    # exposed_comm_per_iter is only ever re-priced for network-tier
    # (multi-rack) placements — which are never indexed.  So place/evict
    # hooks suffice; the only query-time predicate is runtime eligibility.
    # The full-scan recompute is retained below (_tolerant_buckets_scan)
    # as the reference the differential suite pins the index against.

    def note_place(self, job, sim):
        if (job.plan is not None and job.placement_tier != "network"
                and self._rack_scale(job) == 0.0 and self._runs_cheap(job)):
            r = job.placement.alloc[0][0] // sim.cluster.machines_per_rack
            self._tolerant_by_rack.setdefault(r, {})[job.job_id] = job

    def note_evict(self, job, sim):
        if job.plan is None or job.placement_tier == "network":
            return
        r = job.placement.alloc[0][0] // sim.cluster.machines_per_rack
        bucket = self._tolerant_by_rack.get(r)
        if bucket is not None:
            bucket.pop(job.job_id, None)
            if not bucket:
                del self._tolerant_by_rack[r]

    def _tolerant_buckets_indexed(self, sim, now):
        """rack -> displaceable tolerant victims, from the incremental
        index, filtered by runtime eligibility.  Bucket order is index
        insertion order — observationally neutral: every consumer
        re-sorts by the total key ``(-n_gpus, job_id)``."""
        out = {}
        min_rt = self.upgrade_min_runtime
        for r, bucket in self._tolerant_by_rack.items():
            jobs = [t for t in bucket.values()
                    if now - t.last_assignment_time >= min_rt]
            if jobs:
                out[r] = jobs
        return out

    def _tolerant_buckets_scan(self, sim, now):
        """Reference recompute of the victim buckets by scanning the whole
        running set (the pre-index implementation).  Victims must have
        rack scale EXACTLY 0 (dp=1: no sensitive outer traffic at all):
        only then are their delay timers truly zero after the preempt, so
        they re-place at whatever tier is free this same round — a
        partially sensitive victim (dp>1) would instead sit out a scaled
        timer in the queue, costing more than the EP job gains."""
        cl = sim.cluster
        by_rack = {}
        for t in sim.running:
            if (self._rack_scale(t) != 0.0
                    or not self._runs_cheap(t)
                    or (now - t.last_assignment_time
                        < self.upgrade_min_runtime)):
                continue
            racks = {m // cl.machines_per_rack
                     for m, _ in t.placement.alloc}
            if len(racks) == 1:
                by_rack.setdefault(racks.pop(), []).append(t)
        return by_rack

    # -- straggler reaction (degradation subsystem) ---------------------
    # evict-or-tolerate: a job pinned to a badly degraded machine is
    # preempted so it re-places on healthy capacity; mild degradation is
    # ridden out (the restore surcharge would cost more than the slowdown)
    straggler_evict_factor = 1.5
    straggler_evictions_per_round = 2

    def _straggler_scan(self, sim, now):
        """Evict-or-tolerate over the currently degraded machines (via
        the per-machine index — never a running-set scan).  Eligibility
        is gated exactly like preemption: a job keeps its placement
        until it has held resources for ``preemption_min_runtime`` —
        and tolerates when the factor is mild, when healthy free
        capacity could not re-host it anyway, or (implicitly) when it
        is about to finish (the COMPLETE event fires before the next
        round)."""
        evicted = 0
        for m in sorted(sim.machine_degrade):
            if evicted >= self.straggler_evictions_per_round:
                return
            if sim.machine_degrade[m] < self.straggler_evict_factor:
                continue  # tolerate: mild episode
            for job in list(sim._jobs_on_machine.get(m, {}).values()):
                if evicted >= self.straggler_evictions_per_round:
                    return
                if job.placement is None:
                    continue
                if job.degrade_factor < self.straggler_evict_factor:
                    continue  # this job's worst machine is a mild one
                if now - job.last_assignment_time \
                        <= sim.preemption_min_runtime:
                    continue  # tolerate: not yet preemption-eligible
                if sim.cluster.free_gpus() < job.n_gpus:
                    continue  # tolerate: nowhere to re-host it
                sim.preempt(job, now)
                sim.n_straggler_evictions += 1
                evicted += 1

    def on_round(self, sim, now):
        prof = sim.profile
        t0 = perf_counter() if prof is not None else 0.0
        if sim.machine_degrade:
            # empty dict on every degradation-off run: goldens untouched
            self._straggler_scan(sim, now)
        if prof is not None:
            prof.add("straggler_scan", perf_counter() - t0)
            t0 = perf_counter()
        self._yield_rack_slots(sim, now)
        if prof is not None:
            prof.add("rack_yield_scan", perf_counter() - t0)
            t0 = perf_counter()
        # a fully busy cluster admits NO upgrade: every reachable tier
        # needs free GPUs beyond the job's own (a rack-/network-tier
        # placement spans >= 2 machines/racks, so its own share on any
        # one machine/rack is < n_gpus, and all free counts are 0) —
        # `upgrade_level` would return None for every candidate, so the
        # filter + nw_sens sort + probes are skipped wholesale.  This is
        # the steady state of every congested regime.
        if sim.cluster.free_gpus() > 0:
            # candidate pre-filter: machine-tier jobs can never upgrade
            # (the simulator tracks the rack-/network-tier minority
            # incrementally) and young jobs aren't eligible yet, so only
            # the few consolidatable jobs pay the nw_sens sort — the
            # running set itself can be thousands of jobs at datacenter
            # scale.  Placements of OTHER jobs never change inside the
            # loop, so filtering up front is decision-identical to the
            # old skip-inside-sorted-loop.
            # eligibility anchors on last_assignment_time: _reprice
            # resets run_start on every shared-fabric fold, which
            # silently disabled upgrades for contended jobs — the ones
            # that need them most
            cands = [j for j in sim.running_scattered
                     if now - j.last_assignment_time
                     >= self.upgrade_min_runtime]
            done = 0
            for job in self._rank_by_nw_sens(cands, now):
                if done >= self.upgrades_per_round:
                    break
                level = sim.upgrade_level(job)
                if level is not None:
                    sim.migrate(job, level, now)
                    done += 1
        if prof is not None:
            prof.add("upgrade_scan", perf_counter() - t0)

    @staticmethod
    def _rank_by_nw_sens(jobs, now):
        """Ascending nw_sens, original order on ties — ``sorted`` and the
        numpy stable argsort over the bit-identical batch scores produce
        the same permutation."""
        if len(jobs) >= _VEC_MIN_SCORE:
            scores = nw_sens_many(jobs, now)
            if scores is not None:
                return [jobs[i] for i in scores.argsort(kind="stable")]
        return sorted(jobs, key=lambda j: j.nw_sens(now))

    def _yield_rack_slots(self, sim, now):
        """Pattern-aware consolidation (the tentpole's placement claim):
        a waiting expert-parallel job whose all-to-all is hyper-sensitive
        to cross-rack placement may claim a rack by migrating tolerant
        (pipeline-heavy) running jobs out of it — their stage-boundary
        point-to-point traffic runs at the network tier for ~free, so the
        swap is strictly profitable in the traffic model.  Plan-less
        workloads never enter here: legacy schedules are bit-identical."""
        if not sim.any_plans:
            return  # plan-less workload: don't scan the queue every round
        cl = sim.cluster
        done = 0
        sensitive = [j for j in sim.waiting
                     if j.plan is not None
                     and j.n_gpus <= cl.max_rack_capacity
                     and self._rack_scale(j) > self.SENSITIVE_RACK_SCALE]
        if not sensitive:
            return
        sensitive.sort(key=lambda j: (j.nw_sens(now), j.arrival, j.job_id))
        for job in sensitive:
            if done >= self.yields_per_round:
                return
            g = job.n_gpus
            if cl.max_free_on_rack() >= g:
                continue  # a plain rack offer succeeds this round anyway
            # displaceable running jobs, bucketed by the single rack they
            # sit in — from the incremental victim index (the preempts/
            # place below update it through note_place/note_evict, so the
            # per-sensitive-job requery sees mid-loop changes exactly
            # like the old full rescan of sim.running did)
            by_rack = self._tolerant_buckets_indexed(sim, now)
            for r, tolerant in sorted(by_rack.items()):
                have = cl.rack_free(r)
                evict = []
                for t in sorted(tolerant,
                                key=lambda x: (-x.placement.n_gpus,
                                               x.job_id)):
                    if have >= g:
                        break
                    evict.append(t)
                    have += t.placement.n_gpus
                if have < g:
                    continue
                # the displaced jobs must be re-hostable on WHOLE free
                # machines outside rack r: a TP group restarted onto
                # fragments spills its activation all-gather to the worst
                # tier, erasing the yield's profit (and then some)
                gpm = cl.gpus_per_machine
                whole_free = cl.n_whole_free_machines(exclude_rack=r)
                needed = sum(-(-t.placement.n_gpus // gpm) for t in evict)
                if whole_free < needed:
                    continue
                for t in evict:
                    sim.preempt(t, now)  # re-queues; its timers are ~0, so
                    # it restarts at whatever tier is free this round
                sim.place(job, "rack", now)  # rack r now holds >= g
                done += 1
                break
