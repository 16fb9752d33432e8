"""Fault-tolerant checkpointing (``repro.checkpoint.manager`` twin).

* atomic: write to a temp dir, fsync, rename (a crash never corrupts the
  latest checkpoint)
* async: the state is copied to host memory before ``save`` returns, then
  serialised on a background thread; one save is in flight at a time, and
  its error surfaces at the next ``wait`` (or ``save``)
* retention: keep the last K checkpoints
* the JAX package's format: ``arrays.npz`` holds leaf i as ``a{i}`` in
  ``jax.tree.flatten``'s order (``repro_torch.tree``), bf16 as a uint16
  view, and ``structure.json`` the step and each leaf's dtype, so a
  checkpoint that either package writes restores in the other.

This is the mechanism behind the paper's preemption contract (§IV-B): "the
job executes from its last saved state [model params, optimizer state,
iterations completed]".
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import tempfile
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.tree import leaves, paths, unflatten

_NUMPY_DTYPE = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.int32: "int32",
                torch.int64: "int64", torch.float64: "float64", torch.float16: "float16"}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy, never a view of ``t``'s storage: the train step updates
    the state in place while the copy is written."""
    host = t.detach().to("cpu", copy=True)
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().view(np.uint16)
    return host.numpy()


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, dtype=dtype))


class CheckpointManager:
    def __init__(self, directory, *, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _step_dirs(self):
        out = []
        for p in self.dir.iterdir():
            if p.is_dir() and p.name.startswith("step_"):
                try:
                    out.append((int(p.name.split("_")[1]), p))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        dirs = self._step_dirs()
        return dirs[-1][0] if dirs else None

    def _write(self, step: int, arrays, structure):
        tmp = pathlib.Path(tempfile.mkdtemp(dir=self.dir, prefix=".tmp_"))
        try:
            np.savez(tmp / "arrays.npz", **{f"a{i}": a for i, a in enumerate(arrays)})
            (tmp / "structure.json").write_text(json.dumps(structure))
            for name in ("arrays.npz", "structure.json"):
                with open(tmp / name, "rb") as f:
                    os.fsync(f.fileno())
            final = self.dir / f"step_{step:08d}"
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)  # atomic publish
            for _, p in self._step_dirs()[: -self.keep]:
                shutil.rmtree(p, ignore_errors=True)
        except BaseException as e:  # recorded for the next wait(), then re-raised
            shutil.rmtree(tmp, ignore_errors=True)
            self._error = e
            raise

    def save(self, step: int, state: Dict[str, Any], *, blocking=False):
        """Copy ``state`` to host memory, then serialise it on a background thread."""
        self.wait()  # one in-flight save; also surfaces the previous one's error
        flat = leaves(state)
        arrays = [_to_numpy(t) for t in flat]
        structure = {"step": step, "dtypes": [_NUMPY_DTYPE[t.dtype] for t in flat],
                     "paths": paths(state)}
        t = threading.Thread(target=self._write, args=(step, arrays, structure), daemon=True)
        t.start()
        self._thread = t
        if blocking:
            self.wait()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, like: Dict[str, Any], step: Optional[int] = None):
        """The checkpoint at ``step`` (the latest when None) in the structure
        of ``like``, each leaf on its ``like`` leaf's device in the dtype it
        was saved in; None when there is no such checkpoint."""
        dirs = dict(self._step_dirs())
        if step is None:
            step = self.latest_step()
        if step is None or step not in dirs:
            return None
        meta = json.loads((dirs[step] / "structure.json").read_text())
        refs = leaves(like)
        if len(meta["dtypes"]) != len(refs):
            raise ValueError(f"checkpoint step {step} holds {len(meta['dtypes'])} leaves, "
                             f"the state {len(refs)}")
        out = []
        with np.load(dirs[step] / "arrays.npz") as data:
            for i, ref in enumerate(refs):
                t = _from_numpy(data[f"a{i}"], meta["dtypes"][i])
                if tuple(t.shape) != tuple(ref.shape):
                    raise ValueError(f"checkpoint step {step} leaf {i} has shape "
                                     f"{tuple(t.shape)}, the state {tuple(ref.shape)}")
                out.append(t.to(ref.device))
        return unflatten(like, out)
