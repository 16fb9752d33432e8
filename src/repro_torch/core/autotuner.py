"""Delay-timer auto-tuner (paper Algo 2).

Maintains per-(tier x GPU-demand) lists of observed starvation (wait) times.
``get_tuned_timers`` returns mean + 2*stddev over a sliding window — two
standard deviations above the mean = 95% confidence, the paper's choice.

Window semantics: Algo 2's pseudocode compares entries against
HISTORY_TIME_LIMIT directly; the prose ("sliding window size", "larger
clusters need a smaller history limit because more jobs get placed over
time") implies an *age*-based window.  We implement the age-based reading
(entries observed more than HISTORY_TIME_LIMIT ago are dropped) and note the
ambiguity in DESIGN.md.

Caching: the memo used to key on ``(g, now)`` — with ``now`` advancing
every scheduling round the hit rate was ~0%, every miss re-filtered the
full tier history (without ever pruning it on the fallback path), and the
tuner dominated datacenter-scale runs.  Timer values only change when a
new observation lands or an old one ages out, so the caches below key on
what actually varies: one memo per (tier, demand) bucket and one per-tier
aggregate for the cold-start fallback, each stamped with a
``valid_until`` (the earliest contributing entry's expiry; +inf when
nothing can age out).  ``update_demand_delay`` invalidates exactly the
bucket it touched plus that tier's aggregate.  The computed values are
bit-identical to the uncached math — the regression tests pin this.
"""
from __future__ import annotations

import math
from collections import defaultdict, deque
from typing import Dict, Optional, Tuple


def _bucket() -> Tuple[deque, deque]:
    """Demand-bucket factory: parallel (observed_at, wait_time) deques.
    Splitting the old deque-of-pairs lets the aggregation paths consume
    the wait column wholesale (``extend`` / ``list``) instead of
    destructuring a tuple per entry — the tuner's former hot loop.  A
    module-level function (not a lambda) keeps the defaultdict picklable
    for service snapshots."""
    return (deque(), deque())


class AutoTuner:
    def __init__(self, history_time_limit: float = 7 * 24 * 3600.0,
                 default_machine: float = 12 * 3600.0,
                 default_rack: float = 12 * 3600.0):
        self.history_time_limit = history_time_limit
        self.default = {"machine": default_machine, "rack": default_rack}
        # monotone observation counter: bumps on every recorded wait.
        # Policies memoize schedule-affecting timer reads on
        # (now, version) — timer values can only change when `now` moves
        # or an observation lands, so an equal stamp proves the repeat
        # call would return the same value AND mutate nothing new (the
        # first call at this stamp already created/pruned the buckets).
        self.version = 0
        # fine-grained observation stamps, the dependency half of offer
        # holds: a timer served from bucket (tier, g) can only change on
        # an observation for that same (tier, g); one served through the
        # tier aggregate (or the cold default) on any same-tier
        # observation.  Both are exactly what update_demand_delay
        # invalidates below.
        self._obs_version: Dict[Tuple[str, int], int] = {}
        self._agg_version: Dict[str, int] = {}
        # (tier, g) -> parallel (times, waits) deques
        self.lists: Dict[Tuple[str, int],
                         Tuple[deque, deque]] = defaultdict(_bucket)
        # (tier, g) -> (valid_until, timer | None); None = bucket empty,
        # resolve through the tier aggregate
        self._bucket_cache: Dict[Tuple[str, int],
                                 Tuple[float, Optional[float]]] = {}
        # tier -> (valid_until, timer | None); None = tier never observed
        # anything fresh, resolve to the default
        self._agg_cache: Dict[str, Tuple[float, Optional[float]]] = {}

    def update_demand_delay(self, tier: str, wait_time: float, g: int,
                            now: float):
        """Paper Algo 1 lines 7/15: record the starvation time that preceded
        an accepted offer at this consolidation tier."""
        tdq, wdq = self.lists[(tier, g)]
        tdq.append(now)
        wdq.append(wait_time)
        self.version += 1
        self._obs_version[(tier, g)] = self._obs_version.get((tier, g),
                                                             0) + 1
        self._agg_version[tier] = self._agg_version.get(tier, 0) + 1
        # targeted invalidation: only this bucket's memo and this tier's
        # aggregate can change — other demands' exact-bucket values cannot
        self._bucket_cache.pop((tier, g), None)
        self._agg_cache.pop(tier, None)

    def _prune(self, bucket: Tuple[deque, deque], now: float):
        tdq, wdq = bucket
        limit = self.history_time_limit
        while tdq and now - tdq[0] > limit:
            tdq.popleft()
            wdq.popleft()

    @staticmethod
    def _mean_plus_2std(xs) -> float:
        mean = sum(xs) / len(xs)
        # listcomp, not genexpr: sum() over a materialized list skips the
        # generator frame per element — same floats in the same order
        var = sum([(x - mean) ** 2 for x in xs]) / max(len(xs) - 1, 1)
        return mean + 2.0 * math.sqrt(var)

    def _tier_aggregate(self, tier: str, now: float) -> Optional[float]:
        """Cold-start fallback: the tier's history aggregated across all
        demands, pruning aged entries as it goes (the old path re-filtered
        them on every call but never dropped them)."""
        hit = self._agg_cache.get(tier)
        if hit is not None and now <= hit[0]:
            return hit[1]
        xs: list = []
        valid_until = math.inf
        for (t2, _), bucket in list(self.lists.items()):
            if t2 != tier or not bucket[0]:
                continue
            self._prune(bucket, now)
            tdq, wdq = bucket
            if tdq:
                valid_until = min(valid_until,
                                  tdq[0] + self.history_time_limit)
                xs.extend(wdq)
        val = self._mean_plus_2std(xs) if xs else None
        self._agg_cache[tier] = (valid_until, val)
        return val

    def get_tuned_timer(self, tier: str, g: int, now: float) -> float:
        """One tier's timer: per-(tier, g) window -> tier aggregate across
        demands (rare demands would otherwise sit on the cold-start
        default forever — they only record on acceptance *at* that tier)
        -> configured default."""
        return self.timer_and_horizon(tier, g, now)[0]

    def timer_and_horizon(self, tier: str, g: int, now: float
                          ) -> Tuple[float, float, tuple]:
        """``(timer, valid_until, dep)``: the timer plus the two halves
        of its freshness guarantee — the last instant the value is
        unchanged absent new observations (aging bound), and a
        dependency stamp ``(version_dict, key, seen)`` that moves exactly
        when an observation lands that can change THIS value (same
        (tier, g) for a bucket-served timer, same tier for an
        aggregate- or default-served one).  This is what lets the
        scheduler hold a timer-based offer rejection without re-querying:
        the rejection stands while ``now <= valid_until``, the stamp
        still matches, and the job's starvation is still below the
        returned value."""
        key = (tier, g)
        hit = self._bucket_cache.get(key)
        if hit is not None and now <= hit[0]:
            valid_until, val = hit
        else:
            bucket = self.lists[key]
            self._prune(bucket, now)
            tdq, wdq = bucket
            if tdq:
                val = self._mean_plus_2std(list(wdq))
                valid_until = tdq[0] + self.history_time_limit
            else:
                # an empty bucket stays empty until an update (which
                # invalidates), so the miss result never expires
                val, valid_until = None, math.inf
            self._bucket_cache[key] = (valid_until, val)
        if val is not None:
            return val, valid_until, (
                self._obs_version, key, self._obs_version.get(key, 0))
        agg_val = self._tier_aggregate(tier, now)
        # _tier_aggregate just (re)filled its cache entry; its horizon is
        # the earliest expiry among the contributing buckets (+inf when
        # the tier has nothing fresh — only an update can change that).
        # An empty bucket can only stop resolving here via an update for
        # its own (tier, g), which bumps the tier stamp too — so the
        # tier-level dep covers the default path as well.
        agg_valid_until = self._agg_cache[tier][0]
        dep = (self._agg_version, tier, self._agg_version.get(tier, 0))
        if agg_val is not None:
            return agg_val, agg_valid_until, dep
        return self.default[tier], agg_valid_until, dep

    def get_tuned_timers(self, g: int, now: float) -> Tuple[float, float]:
        """Returns (T_machine, T_rack) = mean + 2*stddev per tier."""
        return (self.get_tuned_timer("machine", g, now),
                self.get_tuned_timer("rack", g, now))

    def peek_timer(self, tier: str, g: int, now: float) -> float:
        """Read-only twin of :meth:`get_tuned_timer`: same value, ZERO
        mutation — no defaultdict bucket creation, no pruning, no cache
        writes.  The service's live cluster-state query goes through this:
        ``get_tuned_timer`` is schedule-affecting even as a "read" (a new
        ``self.lists`` bucket changes the dict's insertion order, which
        changes the float-summation order inside ``_tier_aggregate``), so
        observing a running daemon must never call it."""
        bucket = self.lists.get((tier, g))
        if bucket and bucket[0]:
            fresh = [w for t, w in zip(bucket[0], bucket[1])
                     if now - t <= self.history_time_limit]
            if fresh:
                return self._mean_plus_2std(fresh)
        xs: list = []
        for (t2, _), (tdq, wdq) in self.lists.items():
            if t2 != tier:
                continue
            xs.extend(w for t, w in zip(tdq, wdq)
                      if now - t <= self.history_time_limit)
        if xs:
            return self._mean_plus_2std(xs)
        return self.default[tier]
