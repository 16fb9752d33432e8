"""PyTorch and CUDA port of the model substrate, for NVIDIA Hopper.

The JAX package ``repro`` is the reference.  This package imports nothing of
it: it holds its own copy of every piece it needs, keeps the same parameter
layout, and replaces each Pallas TPU kernel with a kernel written for
``sm_90a``.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; raises rather than fall back.

    ``"cuda"`` with no visible GPU is an error, never a silent move to the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was asked for but torch sees no CUDA device; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
