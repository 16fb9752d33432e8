"""Build a CUDA source into a shared library with a plain C interface.

Each kernel is compiled by ``nvcc`` for ``sm_90a`` at first use, into
``build/repro_torch/`` at the root of the checkout (listed in .gitignore).
The library's file name carries a hash of its sources and flags, so a
changed source is rebuilt and an unchanged one is loaded as it is.  Nothing
is built when a module is imported.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class Built:
    path: Path        # the shared library
    log: str          # nvcc's output, ptxas's register and spill summary included
    seconds: float    # time nvcc took; 0.0 when the library was already built


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found on PATH nor under /usr/local/cuda/bin; "
                       "the CUDA kernels cannot be built")


def build_shared_library(name: str, sources: list[Path]) -> Built:
    """Compile ``sources`` into ``lib<name>-<hash>.so``; raise if nvcc fails."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    stem = f"lib{name}-{digest.hexdigest()[:16]}"
    lib, log_path = BUILD_DIR / f"{stem}.so", BUILD_DIR / f"{stem}.log"
    if lib.exists() and log_path.exists():
        return Built(lib, log_path.read_text(), 0.0)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{stem}.{os.getpid()}.tmp.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building {name}:\n"
                           f"{' '.join(cmd)}\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)  # atomic: a concurrent build sees the whole file or none
    return Built(lib, log, seconds)


def ptxas_summary(log: str) -> list[str]:
    """ptxas's per-kernel lines: the kernel, its registers, stack and spills."""
    return [ln.strip() for ln in log.splitlines()
            if "entry function" in ln or "registers" in ln or "spill" in ln]
