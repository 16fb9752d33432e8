"""Incremental JSONL spill of finished-job records.

Constant-memory replay needs ``results()`` to aggregate without
retaining every finished ``Job``: the simulator folds each completion
into a :class:`repro_torch.core.metrics.FinishedTally` and hands the full
per-job record here, where it is appended to a rotating JSONL shard
with an incrementally-updated sha256.  The shard digests land in the
run's provenance (schema-v6 artifacts record them), so a spilled run's
per-job output is content-addressed even though it never lived in
memory.

Spilling is a batch-mode feature: a simulator with a spill writer
attached refuses ``snapshot_bytes()`` (the open file handles and
rolling hash have no snapshot semantics; the service never spills).
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

#: default completions per shard — ~250k short JSON lines per file keeps
#: shards in the tens of MB and the manifest small at million-job scale
DEFAULT_SHARD_JOBS = 250_000


class SpillWriter:
    """Rotating JSONL shard writer with per-shard content digests."""

    def __init__(self, out_dir, shard_jobs: int = DEFAULT_SHARD_JOBS,
                 prefix: str = "finished"):
        self.out_dir = str(out_dir)
        self.shard_jobs = int(shard_jobs)
        self.prefix = prefix
        os.makedirs(self.out_dir, exist_ok=True)
        self._shards = []  # closed-shard manifest entries
        self._fh = None
        self._hash = None
        self._count = 0  # records in the open shard
        self._total = 0

    def write(self, record: dict) -> None:
        if self._fh is None:
            name = f"{self.prefix}-{len(self._shards):05d}.jsonl"
            self._fh = open(os.path.join(self.out_dir, name), "wb")
            self._hash = hashlib.sha256()
            self._count = 0
        line = (json.dumps(record, sort_keys=True,
                           separators=(",", ":")) + "\n").encode()
        self._fh.write(line)
        self._hash.update(line)
        self._count += 1
        self._total += 1
        if self._count >= self.shard_jobs:
            self._close_shard()

    def _close_shard(self) -> None:
        name = os.path.basename(self._fh.name)
        self._fh.close()
        self._shards.append({"file": name, "n_jobs": self._count,
                             "sha256": self._hash.hexdigest()})
        self._fh = None
        self._hash = None
        self._count = 0

    def close(self) -> None:
        if self._fh is not None:
            self._close_shard()

    def manifest(self) -> dict:
        """Close any open shard and describe what was written — JSON-safe,
        recorded in v6 artifacts.  Idempotent."""
        self.close()
        return {"dir": self.out_dir, "n_jobs": self._total,
                "shard_jobs": self.shard_jobs,
                "shards": list(self._shards)}


def finished_record(job) -> dict:
    """The per-job record spilled at its COMPLETE event — everything the
    materialized ``finished`` list could answer about the job."""
    return {
        "job_id": job.job_id,
        "model": job.model,
        "n_gpus": job.n_gpus,
        "total_iters": job.total_iters,
        "arrival": job.arrival,
        "finish_time": job.finish_time,
        "jct": job.finish_time - job.arrival,
        "t_queue": job.t_queue,
        "t_run": job.t_run,
        "comm_time": job.comm_time,
        "preemptions": job.preemptions,
        "failures": job.failures,
    }


def read_spilled(out_dir, prefix: str = "finished"):
    """Yield the spilled records of a run directory in completion order
    (shards are numbered; lines within a shard are append-ordered)."""
    names = sorted(n for n in os.listdir(out_dir)
                   if n.startswith(prefix + "-") and n.endswith(".jsonl"))
    for name in names:
        with open(os.path.join(out_dir, name)) as f:
            for line in f:
                if line.strip():
                    yield json.loads(line)


def verify_manifest(manifest: dict) -> Optional[str]:
    """Re-hash the shards on disk against the manifest digests; returns
    an error string on the first mismatch, None when everything checks
    out (the replay harness and tests use this as the integrity gate)."""
    for entry in manifest.get("shards", []):
        path = os.path.join(manifest["dir"], entry["file"])
        h = hashlib.sha256()
        try:
            with open(path, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
        except OSError as e:
            return f"{entry['file']}: {e}"
        if h.hexdigest() != entry["sha256"]:
            return f"{entry['file']}: sha256 mismatch"
    return None
