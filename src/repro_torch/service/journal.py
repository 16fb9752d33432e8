"""Durable JSONL write-ahead journal for the scheduler service.

One record per line, ``{"type": ...}``-discriminated:

* ``submit``   — a job accepted into the simulator.  Written (flushed AND
  fsynced) *before* the simulator sees the job: if the record is on disk
  the job is replayable, if it is not the job never happened.  Carries the
  original spec and the fully-derived job fields, so replay is immune to
  derivation-default drift between releases.
* ``event``    — an externally-visible scheduler action (place / preempt /
  crash / complete / machine_fail / machine_recover / reject), emitted via
  the simulator's ``op_hook``.  Observability records: they are flushed
  per tick, not fsynced per record, and recovery may re-emit a suffix of
  them (at-least-once).  They take no part in state reconstruction.
* ``snapshot`` — a full pickled-simulator checkpoint landed on disk
  (``file`` + ``sha256`` + the number of submits it contains, plus the
  tenant-ledger counters as of that instant).  Recovery loads the newest
  snapshot that exists and verifies, then replays the ``submit`` records
  after it.
* ``admission`` — one admission-control decision (``admit`` or ``reject``
  with the reason), emitted only when an :class:`AdmissionPolicy` is
  configured.  A reject record is fsynced *before* the rejection is
  raised to the caller; an admit record rides the immediately following
  durable ``submit``.  Recovery rebuilds the auditable admission log from
  these; they take no part in simulator state reconstruction.

The reader tolerates a truncated final line (the crash window of an
append) and skips records of unknown type, so the format is forward-
extensible.
"""
from __future__ import annotations

import json
import os
import pathlib
from typing import Iterator, List, Optional, Union

JOURNAL_SCHEMA = "repro.service.journal/v1"


class Journal:
    """Append-oriented JSONL log.  One instance owns the file handle; the
    service keeps it open for the daemon's lifetime."""

    def __init__(self, path: Union[str, pathlib.Path]):
        self.path = pathlib.Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a", encoding="utf-8")

    # -- writing --------------------------------------------------------
    def append(self, record: dict, *, durable: bool = False) -> None:
        """Append one record.  ``durable=True`` flushes AND fsyncs before
        returning — the WAL discipline for ``submit``/``snapshot`` records;
        ``event`` records skip the fsync and are made durable in batches
        by :meth:`flush`."""
        self._fh.write(json.dumps(record, sort_keys=True) + "\n")
        if durable:
            self._fh.flush()
            os.fsync(self._fh.fileno())

    def flush(self, *, fsync: bool = False) -> None:
        self._fh.flush()
        if fsync:
            os.fsync(self._fh.fileno())

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.flush()
            self._fh.close()

    def __enter__(self) -> "Journal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- reading --------------------------------------------------------
    @staticmethod
    def read(path: Union[str, pathlib.Path]) -> List[dict]:
        """All parseable records.  A truncated / corrupt FINAL line is the
        normal crash window of an append and is dropped silently; a corrupt
        line in the middle means the file was damaged some other way and
        raises."""
        return list(Journal.iter_records(path))

    @staticmethod
    def iter_records(path: Union[str, pathlib.Path]) -> Iterator[dict]:
        path = pathlib.Path(path)
        if not path.exists():
            return
        with open(path, encoding="utf-8") as fh:
            lines = fh.read().splitlines()
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    return  # torn tail write: expected after SIGKILL
                raise ValueError(
                    f"{path}: corrupt journal record at line {i + 1}")


def last_snapshot_record(records) -> Optional[dict]:
    """The newest ``snapshot`` record, or None."""
    out = None
    for rec in records:
        if rec.get("type") == "snapshot":
            out = rec
    return out
