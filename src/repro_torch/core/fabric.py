"""Endogenous cross-job network contention: the shared-fabric model.

The cluster's inter-rack fabric is a two-level tree — every rack has one
uplink into a single spine.  A cross-rack (network-tier) placement's
all-reduce ring traverses the uplink of each rack it spans plus the
spine; placements that share a link split its capacity equally.  A job's
effective inter-node bandwidth is therefore

    bw(j) = min( nic_bw,  min over links l of  capacity(l) / n_users(l) )

i.e. the per-participant NIC rate capped by the job's most contended
link's fair share.  Machine- and rack-tier placements never leave the
ToR switch and are unaffected — which is exactly why consolidation pays
off under congestion (the regime of Wang et al., arXiv:2002.10105, and
Ryu & Eo, arXiv:2310.20209).

Link capacities come from the topology (``rack_uplink_bw`` /
``spine_bw``); when unset, uncontended defaults of 4x (uplink) and 8x
(spine) the NIC rate apply, so up to 4 jobs per uplink and 8 across the
spine run at full speed before fair-sharing bites.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

from .topology import ClusterTopology

# default link capacities as multiples of the per-participant NIC rate
DEFAULT_UPLINK_X = 4.0
DEFAULT_SPINE_X = 8.0


class FairShareFabric:
    """Computes per-job inter-node bandwidth under equal-share contention.

    ``nic_bw`` is the per-participant network-tier bandwidth from the
    hardware profile — the ceiling a job sees on an empty fabric, which
    keeps the model exactly backward-compatible when nothing contends.
    """

    def __init__(self, cluster: ClusterTopology, nic_bw: float,
                 rack_uplink_bw: Optional[float] = None,
                 spine_bw: Optional[float] = None):
        assert nic_bw > 0
        self.cluster = cluster
        self.nic_bw = nic_bw
        self.rack_uplink_bw = (rack_uplink_bw
                               if rack_uplink_bw is not None
                               else cluster.rack_uplink_bw)
        if self.rack_uplink_bw is None:
            self.rack_uplink_bw = DEFAULT_UPLINK_X * nic_bw
        self.spine_bw = spine_bw if spine_bw is not None else cluster.spine_bw
        if self.spine_bw is None:
            self.spine_bw = DEFAULT_SPINE_X * nic_bw
        # Incremental membership state (the simulator's hot path): per
        # link an insertion-ordered {job_id: weight} map.  The running
        # list only ever gains members by append (``_start``), and a
        # removal preserves the order of the rest in dict and list alike,
        # so each map's iteration order IS the running-list order of that
        # link's users — which makes the per-link load re-sum below
        # bit-identical to the from-scratch path in :meth:`fair_shares`
        # (same floats, same left-to-right addition order).
        self._members: Dict[tuple, Dict[int, float]] = {}
        self._links_of: Dict[int, tuple] = {}
        self._loads: Dict[tuple, float] = {}
        self._dirty: set = set()
        # per-link bandwidth derating (degradation subsystem): factor in
        # (0, 1) while a link is degraded, absent when healthy.  Applied
        # inside _capacity so BOTH pricing paths (the reference
        # fair_shares and the incremental share_of) compose derating with
        # fair-share contention identically; an absent link returns the
        # nominal capacity float untouched, keeping degradation-off runs
        # bit-identical.
        self._derate: Dict[tuple, float] = {}

    def _capacity(self, link) -> float:
        cap = self.spine_bw if link == self.cluster.SPINE \
            else self.rack_uplink_bw
        d = self._derate.get(link)
        return cap if d is None else cap * d

    # -- degradation seam ------------------------------------------------
    def set_derate(self, link, factor: float) -> bool:
        """Derate ``link`` to ``factor`` x nominal capacity (1.0
        restores).  Returns True when the change can affect a currently
        registered placement — the caller should re-price then."""
        if factor == 1.0:
            changed = self._derate.pop(link, None) is not None
        else:
            changed = self._derate.get(link) != factor
            self._derate[link] = factor
        if changed and self._members.get(link):
            self._dirty.add(link)
            return True
        return False

    def effective_bandwidth(self, link) -> float:
        """Telemetry probe: the bandwidth a marginal participant would see
        through ``link`` right now — derated capacity split by the current
        fair-share load, capped at the NIC rate (nominal capacity, NIC-
        capped, when nobody loads it)."""
        members = self._members.get(link)
        if not members:
            return min(self.nic_bw, self._capacity(link))
        load = self._loads.get(link)
        if load is None or link in self._dirty:
            load = 0.0
            for w in members.values():
                load += w
        return min(self.nic_bw, self._capacity(link) / load)

    def fair_shares(self, jobs: Iterable) -> Dict[int, float]:
        """job_id -> effective inter-node bandwidth for every cross-rack
        job in ``jobs`` (jobs whose traffic stays under one ToR are
        absent: they run at the profile's tier rate, uncontended).

        Each job loads the links it traverses by its parallelism plan's
        ``fabric_weight`` — the pattern's actual traffic intensity
        relative to a pure-DP gradient ring (which weighs 1.0, keeping
        plan-less workloads on the exact equal-share math).  A pipeline-
        parallel job's point-to-point stage traffic barely dents its
        neighbours' shares; an expert-parallel all-to-all loads them
        harder than a gradient ring would."""
        links_of: Dict[int, tuple] = {}
        users: Dict[tuple, float] = {}
        for job in jobs:
            # machine-/rack-tier placements have no fabric links by
            # definition; the pinned tier (when the simulator provides it)
            # skips the link lookup for the large consolidated majority
            if getattr(job, "placement_tier", None) not in (None, "network"):
                continue
            links = self.cluster.placement_links(job.placement)
            if not links:
                continue
            links_of[job.job_id] = links
            w = 1.0 if job.plan is None else job.plan.fabric_weight
            for link in links:
                users[link] = users.get(link, 0.0) + w
        return {
            jid: min(self.nic_bw,
                     min(self._capacity(link) / users[link]
                         for link in links))
            for jid, links in links_of.items()
        }

    # -- incremental membership (simulator hot path) ---------------------
    # The simulator registers every network-tier placement as it starts
    # and unregisters it as it tears down; a re-price then only re-solves
    # the links whose membership actually changed and re-prices only
    # their members, instead of recomputing the whole network-tier fleet.
    # ``fair_shares`` above is retained as the reference recompute path —
    # the differential suite pins ``share_of`` bit-identical to it.

    def add_placement(self, job) -> bool:
        """Register a newly started cross-rack job.  Returns True when the
        placement loads any fabric link (i.e. a re-price is due)."""
        links = self.cluster.placement_links(job.placement)
        if not links:
            return False
        w = 1.0 if job.plan is None else job.plan.fabric_weight
        self._links_of[job.job_id] = links
        for link in links:
            self._members.setdefault(link, {})[job.job_id] = w
            self._dirty.add(link)
        return True

    def remove_placement(self, job) -> bool:
        """Unregister a job whose placement is being torn down.  Returns
        True when it was loading any link."""
        links = self._links_of.pop(job.job_id, None)
        if not links:
            return False
        for link in links:
            members = self._members[link]
            del members[job.job_id]
            if members:
                self._dirty.add(link)
            else:
                # nobody left to re-price through this link
                del self._members[link]
                self._loads.pop(link, None)
                self._dirty.discard(link)
        return True

    def take_affected(self) -> set:
        """Job-ids whose fair share may have changed since the last call:
        the current members of every link whose membership changed.  Each
        dirty link's load is re-summed sequentially in insertion (=
        running-list) order, keeping the value bit-identical to the
        recompute path; untouched links keep their cached loads (same
        members => same sum)."""
        affected: set = set()
        loads = self._loads
        for link in self._dirty:
            members = self._members.get(link)
            if not members:
                continue
            load = 0.0
            for w in members.values():
                load += w
            loads[link] = load
            affected.update(members)
        self._dirty.clear()
        return affected

    def share_of(self, job_id: int) -> float:
        """The registered job's effective inter-node bandwidth, from the
        incrementally maintained link loads (call after
        :meth:`take_affected` has drained the dirty set)."""
        loads = self._loads
        return min(self.nic_bw,
                   min(self._capacity(link) / loads[link]
                       for link in self._links_of[job_id]))

    def debug_assert_synced(self, jobs: Iterable) -> None:
        """Test/probe seam: assert the incremental membership state equals
        a from-scratch recompute over ``jobs`` — same links, same member
        order, and bit-identical loads for every clean link."""
        members: Dict[tuple, Dict[int, float]] = {}
        links_of: Dict[int, tuple] = {}
        for job in jobs:
            if getattr(job, "placement_tier", None) not in (None, "network"):
                continue
            links = self.cluster.placement_links(job.placement)
            if not links:
                continue
            links_of[job.job_id] = links
            w = 1.0 if job.plan is None else job.plan.fabric_weight
            for link in links:
                members.setdefault(link, {})[job.job_id] = w
        assert self._links_of == links_of, (self._links_of, links_of)
        assert set(self._members) == set(members)
        for link, want in members.items():
            assert list(self._members[link].items()) == list(want.items()), \
                (link, self._members[link], want)
            if link not in self._dirty:
                load = 0.0
                for w in want.values():
                    load += w
                assert self._loads[link] == load, (link, load)
