"""Build CUDA sources into a shared library with a plain C interface.

Each kernel is compiled by ``nvcc`` for ``sm_90a`` at first use, into
``build/repro_torch/`` at the root of the checkout (listed in .gitignore).
The library's file name carries a hash of its sources and flags, so a
changed source is rebuilt and an unchanged one is loaded as it is.  Every
source may include the headers that the kernels share from ``csrc/`` beside
this file (nvcc gets ``-I`` to it, and the hash covers its files, so a
changed header rebuilds every library).  Nothing is built when a module is
imported.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SHARED_INCLUDE = Path(__file__).resolve().parent / "csrc"  # sm90.cuh
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class Built:
    path: Path        # the shared library
    log: str          # nvcc's output, ptxas's register and spill summary included
    seconds: float    # time the build took; 0.0 when the library was already built
    seconds_by_source: dict[str, float]  # each source's nvcc; empty when already built


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found on PATH nor under /usr/local/cuda/bin; "
                       "the CUDA kernels cannot be built")


def build_shared_library(name: str, sources: list[Path],
                         defines: dict[str, str] | None = None) -> Built:
    """Compile each of ``sources`` by an nvcc of its own, all started
    together, and link them into ``lib<name>-<hash>.so``; raise if nvcc
    fails.  ``defines`` become macros of every source, ``#define name
    value`` in a header that nvcc includes first (a header, not ``-D``, so
    that a value reaches the compiler as written).  The hash covers the
    flags, the defines and every file of the sources' directories and of
    SHARED_INCLUDE, the headers they include among them."""
    header = "".join(f"#define {k} {v}\n" for k, v in (defines or {}).items())
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    digest.update(header.encode())
    dirs = {src.parent for src in sources} | {SHARED_INCLUDE}
    for f in sorted({f for d in dirs if d.is_dir() for f in d.iterdir() if f.is_file()}):
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    stem = f"lib{name}-{digest.hexdigest()[:16]}"
    lib, log_path = BUILD_DIR / f"{stem}.so", BUILD_DIR / f"{stem}.log"
    if lib.exists() and log_path.exists():
        return Built(lib, log_path.read_text(), 0.0, {})
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{stem}.{os.getpid()}.tmp"
    objs = [tmp.with_name(f"{tmp.name}.{i}.o") for i in range(len(sources))]
    flags = [*NVCC_FLAGS, "-I", str(SHARED_INCLUDE)]
    if header:
        defines_h = BUILD_DIR / f"{stem}.h"
        tmp.write_text(header)
        os.replace(tmp, defines_h)
        flags += ["-include", str(defines_h)]
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(len(sources)) as pool:
            runs = list(pool.map(
                lambda src, obj: _nvcc_run(name, [*flags, "-c", "-o", str(obj), str(src)]),
                sources, objs))
        _nvcc_run(name, ["-shared", "-o", str(tmp), *map(str, objs)])
    except RuntimeError:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    log = "".join(out for out, _ in runs)
    log_path.write_text(log)
    os.replace(tmp, lib)  # atomic: a concurrent build sees the whole file or none
    return Built(lib, log, seconds, {src.name: t for src, (_, t) in zip(sources, runs)})


def _nvcc_run(name: str, args: list[str]) -> tuple[str, float]:
    """Run nvcc with ``args``: its output and the seconds it took, or raise
    if it fails."""
    cmd = [_nvcc(), *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building {name}:\n"
                           f"{' '.join(cmd)}\n{log}")
    return log, seconds


def ptxas_summary(log: str) -> list[str]:
    """ptxas's per-kernel lines: the kernel, its registers, stack and spills."""
    return [ln.strip() for ln in log.splitlines()
            if "entry function" in ln or "registers" in ln or "spill" in ln]
