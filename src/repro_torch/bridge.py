"""Move the JAX package's trees into the port, through numpy.

The JAX package's parameter and cache trees are nested dicts (and lists) of
arrays with the same keys and shapes as the port's.  The caller turns them
into numpy arrays (``jax.tree.map(np.asarray, tree)``); this module takes
numpy only and imports nothing of JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device


def _to_tensor(a, device, dtype):
    if not isinstance(a, np.ndarray) or a.dtype.kind not in "fiub":
        raise TypeError("expected a numeric numpy array, got "
                        f"{type(a).__name__} {getattr(a, 'dtype', '')}")
    # a copy: the caller's buffers may be read-only, and the port writes its
    # cache in place
    t = torch.from_numpy(np.array(a))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def params_from_numpy(tree, device="cuda", dtype=None):
    """A parameter tree of numpy arrays as tensors on ``device``.

    Floating leaves are cast to ``dtype`` when it is given.
    """
    dev = resolve_device(device)
    return _map(tree, lambda a: _to_tensor(a, dev, dtype))


def cache_from_numpy(tree, device="cuda", dtype=None):
    """A decode cache ({"pos", "layers"}) of numpy arrays as the port's cache:
    ``pos`` becomes a Python int, the layers tensors on ``device``."""
    dev = resolve_device(device)
    return {"pos": int(tree["pos"]),
            "layers": _map(tree["layers"], lambda a: _to_tensor(a, dev, dtype))}
