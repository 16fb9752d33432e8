"""Hierarchical cluster topology: racks x machines x GPUs.

GPUs are homogeneous; allocations are tracked as per-machine counts.  A
placement's *network tier* is the worst interconnect it spans:
  machine — all GPUs on one machine (NVSwitch / intra-host ICI)
  rack    — one rack, multiple machines (IB Quantum / pod ICI)
  network — multiple racks (Spectrum Ethernet / DCN)

Racks may be heterogeneous (``rack_sizes``): machine ids keep a fixed
per-rack stride of ``machines_per_rack = max(rack_sizes)`` so tier math
stays pure integer division, and the missing machine slots simply hold
zero free GPUs forever.

The topology also carries the *shared fabric* capacities: every rack has
one uplink of ``rack_uplink_bw`` bytes/s into a spine of ``spine_bw``
bytes/s.  A cross-rack (network-tier) placement traverses the uplink of
every rack it spans plus the spine (``placement_links``); co-running
placements that share a link split its capacity (see
``repro_torch.core.fabric``).  ``None`` capacities mean "uncontended" — the
fabric model substitutes profile-derived defaults.

Free-capacity indexing
----------------------
Schedulers query the topology far more often than they mutate it: under
a deep wait queue every round probes ``max_free_on_machine`` /
``max_free_on_rack`` / ``best_feasible_level`` once per waiting job and
the whole-free-machine guard once per upgrade candidate, which made the
original per-query linear scans the wall at datacenter scale (1000+
machines, 10k+ jobs).  ``ClusterTopology`` therefore maintains
incremental indices — per-rack free-GPU counters, global and per-rack
bucket counts of machines by free-GPU level (``n_machines_with_free[k]``)
with lazy max hints, and whole-free-machine counters — updated in O(1)
per touched machine by every ``allocate`` / ``release`` / ``retake``, so
all capacity queries are O(1) (amortized) and allocations scan only on
the success path.  Placement decisions are bit-identical to the original
scans: first-fit machine order, most-free-rack (lowest index on ties)
rack choice, and the stable most-free-first rack fill at network level
are all preserved, which ``NaiveClusterTopology`` — the original
linear-scan implementation, retained as the differential-test
reference — pins.

Machine failures
----------------
``fail_machine`` / ``recover_machine`` mask a machine's capacity while it
is down (hardware failure or maintenance): its free GPUs drop to zero
through the single ``_set_free`` write path, so every incremental index
stays exact and no allocation path can ever land on a dead machine (they
all skip zero-free machines).  ``total_gpus`` is invariant — the masked
capacity is accounted under ``failed_gpus()`` so GPU conservation reads
``allocated + free + failed == total``.  Callers (the simulator) must
release every placement intersecting the machine *before* failing it;
``fail_machine`` asserts the machine is fully free.  Both operations are
inherited unchanged by ``NaiveClusterTopology``, whose linear scans see
the masked ``free`` list and therefore answer every capacity query
identically under failures.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import List, Optional, Sequence

TIERS = ("machine", "rack", "network")


@dataclass(frozen=True)
class Placement:
    """machine_id -> gpu count (machine_id = rack * machines_per_rack + m)."""
    alloc: tuple  # tuple of (machine_id, count), sorted

    @property
    def n_gpus(self) -> int:
        return sum(c for _, c in self.alloc)

    def machines(self) -> List[int]:
        return [m for m, _ in self.alloc]

    def tier(self, machines_per_rack: int) -> str:
        ms = self.machines()
        if len(ms) == 1:
            return "machine"
        racks = {m // machines_per_rack for m in ms}
        return "rack" if len(racks) == 1 else "network"

    @cached_property
    def max_share(self) -> int:
        """Largest per-machine GPU count in the allocation.  Since every
        machine's free count is bounded by the cluster-wide maximum, a
        machine-consolidation top-up (``free[m] + share >= g``) can only
        succeed when ``max_free_on_machine + max_share >= g`` — the O(1)
        pre-gate the upgrade scan runs every round for every scattered
        job before paying for the per-machine walk.  (cached_property
        writes to ``__dict__`` directly, so it composes with frozen.)"""
        return max(c for _, c in self.alloc)

    def rack_shares(self, machines_per_rack: int):
        """``({rack: gpus}, max_gpus_on_one_rack)`` — memoized on the
        (immutable) placement; a placement never migrates between
        topologies, so the single cached geometry is safe.  Same dict
        construction order as an inline rebuild (alloc is sorted), which
        keeps the upgrade probe's short-circuit walk identical."""
        cached = self.__dict__.get("_rack_shares")
        if cached is None:
            per: dict = {}
            for m, c in self.alloc:
                r = m // machines_per_rack
                per[r] = per.get(r, 0) + c
            cached = (per, max(per.values()))
            self.__dict__["_rack_shares"] = cached
        return cached


class _FreeList(list):
    """Per-machine free-GPU counts with index maintenance on writes.

    The topology's capacity indices must observe every mutation; routing
    ``free[m] = v`` through the owner keeps external pokes (tests build
    synthetic occupancy states this way) consistent with the O(1) query
    structures instead of silently desynchronizing them."""
    __slots__ = ("_topo",)

    def __setitem__(self, idx, val):
        self._topo._set_free(idx, val)


class ClusterTopology:
    def __init__(self, n_racks: int = 0, machines_per_rack: int = 8,
                 gpus_per_machine: int = 8,
                 rack_sizes: Optional[Sequence[int]] = None,
                 rack_uplink_bw: Optional[float] = None,
                 spine_bw: Optional[float] = None):
        if rack_sizes is not None:
            rack_sizes = tuple(int(s) for s in rack_sizes)
            assert rack_sizes and all(s > 0 for s in rack_sizes)
            n_racks = len(rack_sizes)
            machines_per_rack = max(machines_per_rack, max(rack_sizes))
        else:
            assert n_racks > 0
            rack_sizes = (machines_per_rack,) * n_racks
        self.n_racks = n_racks
        self.machines_per_rack = machines_per_rack
        self.gpus_per_machine = gpus_per_machine
        self.rack_sizes = rack_sizes
        # id space keeps a fixed stride; slots past a rack's size stay at 0
        self.n_machines = n_racks * machines_per_rack
        self.total_gpus = sum(rack_sizes) * gpus_per_machine
        self._free_total = self.total_gpus
        self.max_rack_capacity = max(rack_sizes) * gpus_per_machine
        # --- incremental capacity indices -----------------------------
        gpm = gpus_per_machine
        free = _FreeList([0] * self.n_machines)
        free._topo = self
        self.free = free
        self._rack_free = [size * gpm for size in rack_sizes]
        # n_machines_with_free[k]: how many machines have exactly k free.
        # Ghost stride slots of short racks count under k=0, where no
        # query ever looks.
        self._mach_bucket = [0] * (gpm + 1)
        self._mach_bucket[0] = self.n_machines - sum(rack_sizes)
        self._mach_bucket[gpm] = sum(rack_sizes)
        # n_racks_with_rack_free[v] over v in 0..max_rack_capacity
        self._rack_bucket = [0] * (self.max_rack_capacity + 1)
        for rf in self._rack_free:
            self._rack_bucket[rf] += 1
        # whole-free (fully idle) machines, per rack and in total
        self._whole_free = list(rack_sizes)
        self._whole_free_total = sum(rack_sizes)
        # lazy max hints: the true max is always <= the hint; queries walk
        # the hint down over empty buckets (amortized O(1): each unit of
        # walk-down is paid for by an earlier raise)
        self._mach_max_hint = gpm
        self._rack_max_hint = max(self._rack_free)
        for r, size in enumerate(rack_sizes):
            base = r * machines_per_rack
            for m in range(base, base + size):
                list.__setitem__(free, m, gpm)
        # shared-fabric link capacities (bytes/s); None = uncontended default
        self.rack_uplink_bw = rack_uplink_bw
        self.spine_bw = spine_bw
        self._links_cache = {}
        # failed (masked) machines: id -> capacity masked at fail time
        self._failed = {}
        self._failed_gpus = 0

    # ------------------------------------------------------------------
    def _set_free(self, m: int, new: int):
        """Single write path for per-machine free counts: updates the free
        list and every derived index in O(1)."""
        old = list.__getitem__(self.free, m)
        if new == old:
            return
        assert 0 <= new <= self.gpus_per_machine, (m, new)
        # a dead machine's free count is pinned at 0 until recovery; only
        # recover_machine (which un-registers first) may write it again
        assert not self._failed or m not in self._failed, \
            f"write to failed machine {m}"
        list.__setitem__(self.free, m, new)
        gpm = self.gpus_per_machine
        r = m // self.machines_per_rack
        self._free_total += new - old
        self._mach_bucket[old] -= 1
        self._mach_bucket[new] += 1
        if new > self._mach_max_hint:
            self._mach_max_hint = new
        rf_old = self._rack_free[r]
        self._rack_bucket[rf_old] -= 1
        rf_new = rf_old + new - old
        self._rack_free[r] = rf_new
        self._rack_bucket[rf_new] += 1
        if rf_new > self._rack_max_hint:
            self._rack_max_hint = rf_new
        if old == gpm:
            self._whole_free[r] -= 1
            self._whole_free_total -= 1
        elif new == gpm:
            self._whole_free[r] += 1
            self._whole_free_total += 1

    # ------------------------------------------------------------------
    SPINE = ("spine",)
    _LINKS_CACHE_MAX = 4096

    def placement_links(self, placement: "Placement") -> tuple:
        """Fabric links a placement's inter-node all-reduce traverses:
        one ("uplink", rack) per rack it spans plus the spine — empty for
        machine- and rack-tier placements, whose traffic never leaves the
        ToR switch.  Memoized on the (immutable) allocation: the fabric
        re-prices every running cross-rack job whenever the contending
        set changes, so the same placement is queried many times."""
        cache = self._links_cache
        links = cache.get(placement.alloc)
        if links is None:
            racks = {m // self.machines_per_rack for m, _ in placement.alloc}
            if len(racks) <= 1:
                links = ()
            else:
                links = tuple(("uplink", r)
                              for r in sorted(racks)) + (self.SPINE,)
            if len(cache) >= self._LINKS_CACHE_MAX:
                cache.clear()
            cache[placement.alloc] = links
        return links

    # -- O(1) capacity queries -----------------------------------------
    def free_gpus(self) -> int:
        return self._free_total

    def rack_free(self, rack: int) -> int:
        return self._rack_free[rack]

    def max_free_on_machine(self) -> int:
        h, bucket = self._mach_max_hint, self._mach_bucket
        while h > 0 and bucket[h] == 0:
            h -= 1
        self._mach_max_hint = h
        return h

    def max_free_on_rack(self) -> int:
        h, bucket = self._rack_max_hint, self._rack_bucket
        while h > 0 and bucket[h] == 0:
            h -= 1
        self._rack_max_hint = h
        return h

    def n_whole_free_machines(self, exclude_rack: Optional[int] = None) -> int:
        """Fully idle machines (free == gpus_per_machine), optionally not
        counting one rack — Dally's yield guard asks "can the displaced
        jobs land on whole machines outside rack r" every round."""
        total = self._whole_free_total
        if exclude_rack is not None:
            total -= self._whole_free[exclude_rack]
        return total

    def best_feasible_level(self, g: int) -> Optional[str]:
        if self.max_free_on_machine() >= g:
            return "machine"
        if self.max_free_on_rack() >= g:
            return "rack"
        if self._free_total >= g:
            return "network"
        return None

    # -- machine failure / recovery ------------------------------------
    def machine_capacity(self, m: int) -> int:
        """GPUs this machine slot holds when healthy: ``gpus_per_machine``
        for real machines, 0 for the ghost stride slots of short racks."""
        r, slot = divmod(m, self.machines_per_rack)
        return self.gpus_per_machine if slot < self.rack_sizes[r] else 0

    def is_failed(self, m: int) -> bool:
        return m in self._failed

    def failed_gpus(self) -> int:
        """Capacity currently masked by failed machines.  GPU conservation
        under churn reads ``allocated + free_gpus() + failed_gpus() ==
        total_gpus``."""
        return self._failed_gpus

    def failed_machines(self) -> List[int]:
        return sorted(self._failed)

    def fail_machine(self, m: int):
        """Take machine ``m`` down: mask its capacity out of every free
        index.  The caller must have released every placement that
        intersects it first (the simulator kills those jobs before
        failing the machine), so the machine is fully free here."""
        assert 0 <= m < self.n_machines, m
        assert m not in self._failed, f"machine {m} already failed"
        cap = self.machine_capacity(m)
        assert list.__getitem__(self.free, m) == cap, \
            f"fail_machine({m}) with live placements on it"
        self._set_free(m, 0)   # single write path: all indices stay exact
        self._failed[m] = cap
        self._failed_gpus += cap

    def recover_machine(self, m: int):
        """Bring a failed machine back: unmask its capacity."""
        assert m in self._failed, f"machine {m} is not failed"
        cap = self._failed.pop(m)
        self._failed_gpus -= cap
        assert list.__getitem__(self.free, m) == 0
        self._set_free(m, cap)

    # ------------------------------------------------------------------
    def _pack_machines(self, machine_ids, g: int) -> Optional[list]:
        """Greedy best-fit: fewest machines (largest free first)."""
        free = self.free
        avail = sorted(((free[m], m) for m in machine_ids
                        if free[m] > 0), reverse=True)
        out, need = [], g
        for f, m in avail:
            take = min(f, need)
            out.append((m, take))
            need -= take
            if need == 0:
                return out
        return None

    def allocate(self, g: int, level: str) -> Optional[Placement]:
        """Allocate g GPUs at the given consolidation level (or None).

        machine: all g on one machine (first fit in machine-id order);
        rack: within one rack, fewest machines (most-free rack first,
        lowest index on ties);
        network: anywhere, packing racks with most free space first.

        The O(1) indices gate every path: the per-machine / per-rack
        scans below only run when the allocation is known to succeed, so
        their cost amortizes against actual placements instead of being
        paid by every failing probe.
        """
        if level == "machine":
            if g > self.gpus_per_machine or self.max_free_on_machine() < g:
                return None
            free = self.free
            for m in range(self.n_machines):
                if free[m] >= g:
                    self._set_free(m, free[m] - g)
                    return Placement(((m, g),))
            raise AssertionError("machine index out of sync")
        if level == "rack":
            if g > self.max_rack_capacity or self.max_free_on_rack() < g:
                return None
            # the original scan tried racks most-free-first (stable sort:
            # lowest index on ties) and the first rack with rack_free >= g
            # always packs successfully — i.e. the chosen rack is exactly
            # the most-free one
            r = self._rack_free.index(self.max_free_on_rack())
            base = r * self.machines_per_rack
            packed = self._pack_machines(
                range(base, base + self.machines_per_rack), g)
            assert packed is not None, "rack index out of sync"
            for m, c in packed:
                self._set_free(m, self.free[m] - c)
            return Placement(tuple(sorted(packed)))
        if level == "network":
            if self._free_total < g:
                return None
            # fill rack-by-rack (most free first) to stay as consolidated
            # as possible even at network level
            packed, need = [], g
            for r in sorted(range(self.n_racks),
                            key=lambda rr: -self._rack_free[rr]):
                rf = self._rack_free[r]
                if rf == 0:
                    break  # sorted most-free-first: the rest are empty too
                base = r * self.machines_per_rack
                sub = self._pack_machines(
                    range(base, base + self.machines_per_rack),
                    min(need, rf))
                for m, c in sub:
                    self._set_free(m, self.free[m] - c)
                    packed.append((m, c))
                    need -= c
                if need == 0:
                    break
            assert need == 0
            return Placement(tuple(sorted(packed)))
        if level == "scatter":
            # network-AGNOSTIC allocation: take whatever fragments are free in
            # machine-index order — the placement a consolidation-blind
            # scheduler (Gandiva; Tiresias for low-skew jobs) ends up with
            if self._free_total < g:
                return None
            free = self.free
            packed, need = [], g
            for m in range(self.n_machines):
                f = free[m]
                if f <= 0:
                    continue
                take = min(f, need)
                self._set_free(m, f - take)
                packed.append((m, take))
                need -= take
                if need == 0:
                    break
            assert need == 0
            return Placement(tuple(sorted(packed)))
        raise ValueError(level)

    def release(self, placement: Placement):
        for m, c in placement.alloc:
            new = self.free[m] + c
            assert new <= self.gpus_per_machine, "double free"
            self._set_free(m, new)

    def retake(self, placement: Placement):
        """Inverse of release: re-occupy a placement's exact machines (used
        by migration feasibility probes that temporarily free a running
        job's GPUs)."""
        for m, c in placement.alloc:
            new = self.free[m] - c
            assert new >= 0, "retake of occupied GPUs"
            self._set_free(m, new)


class NaiveClusterTopology(ClusterTopology):
    """The original linear-scan implementation, retained verbatim as the
    differential-test reference and the pre-indexing baseline: the tests
    build it where the indexed class would stand.  Mutations still flow through
    ``_set_free`` (so the inherited indices stay consistent and
    release/retake are shared), but every query and every allocation
    decision below re-derives its answer by scanning ``free`` — the exact
    pre-indexing behaviour the indexed class must reproduce bit-for-bit."""

    def rack_free(self, rack: int) -> int:
        base = rack * self.machines_per_rack
        return sum(list.__getitem__(self.free, m)
                   for m in range(base, base + self.machines_per_rack))

    def max_free_on_machine(self) -> int:
        return max(self.free)

    def max_free_on_rack(self) -> int:
        return max(self.rack_free(r) for r in range(self.n_racks))

    def n_whole_free_machines(self, exclude_rack: Optional[int] = None) -> int:
        gpm = self.gpus_per_machine
        return sum(
            1 for m in range(self.n_machines)
            if (exclude_rack is None
                or m // self.machines_per_rack != exclude_rack)
            and self.free[m] == gpm)

    def best_feasible_level(self, g: int) -> Optional[str]:
        if self.max_free_on_machine() >= g:
            return "machine"
        if self.max_free_on_rack() >= g:
            return "rack"
        if self._free_total >= g:
            return "network"
        return None

    def allocate(self, g: int, level: str) -> Optional[Placement]:
        if level == "machine":
            for m in range(self.n_machines):
                if self.free[m] >= g:
                    self._set_free(m, self.free[m] - g)
                    return Placement(((m, g),))
            return None
        if level == "rack":
            racks = sorted(range(self.n_racks),
                           key=lambda r: -self.rack_free(r))
            for r in racks:
                if self.rack_free(r) < g:
                    continue
                base = r * self.machines_per_rack
                ids = list(range(base, base + self.machines_per_rack))
                packed = self._pack_machines(ids, g)
                if packed:
                    for m, c in packed:
                        self._set_free(m, self.free[m] - c)
                    return Placement(tuple(sorted(packed)))
            return None
        if level == "network":
            if self._free_total < g:
                return None
            packed, need = [], g
            for r in sorted(range(self.n_racks),
                            key=lambda rr: -self.rack_free(rr)):
                base = r * self.machines_per_rack
                ids = list(range(base, base + self.machines_per_rack))
                sub = self._pack_machines(ids, min(need, self.rack_free(r)))
                if sub:
                    for m, c in sub:
                        self._set_free(m, self.free[m] - c)
                        packed.append((m, c))
                        need -= c
                if need == 0:
                    break
            assert need == 0
            return Placement(tuple(sorted(packed)))
        if level == "scatter":
            if self._free_total < g:
                return None
            packed, need = [], g
            for m in range(self.n_machines):
                if self.free[m] <= 0:
                    continue
                take = min(self.free[m], need)
                self._set_free(m, self.free[m] - take)
                packed.append((m, take))
                need -= take
                if need == 0:
                    break
            assert need == 0
            return Placement(tuple(sorted(packed)))
        raise ValueError(level)
