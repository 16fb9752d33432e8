"""The kernels' build on a host without nvcc: the header the tensor-core
kernels share (``kernels/csrc/sm90.cuh``) reaches every compile through
``-I``, and a change to it rebuilds every library, since each library's
hash covers it."""
from pathlib import Path

import pytest

from repro_torch.kernels import build as build_mod
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.rglru_scan import kernel as scan_kernel
from repro_torch.kernels.rwkv6_wkv import kernel as wkv_kernel

BUILDS = {"flash_attention_fwd": fa_kernel.build, "flash_attention_bwd": fa_kernel.build_bwd,
          "rwkv6_wkv_fwd": wkv_kernel.build, "rglru_scan_bwd": scan_kernel.build_bwd}


@pytest.fixture
def nvcc(tmp_path, monkeypatch):
    """_nvcc_run stood in: it records each command and writes its output."""
    commands = []

    def run(name, args):
        commands.append(list(args))
        Path(args[args.index("-o") + 1]).write_bytes(b"")
        return "", 0.0
    monkeypatch.setattr(build_mod, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build_mod, "_nvcc_run", run)
    return commands


def test_the_shared_header_lives_in_one_place():
    """sm90.cuh is in kernels/csrc, not copied beside a library's sources,
    and each tensor-core source includes it by name."""
    kernels = Path(build_mod.__file__).parent
    assert build_mod.SHARED_INCLUDE == kernels / "csrc"
    assert (kernels / "csrc" / "sm90.cuh").is_file()
    assert sorted(p.relative_to(kernels) for p in kernels.rglob("sm90.cuh")) == [
        Path("csrc/sm90.cuh")]
    for src in (*fa_kernel.SOURCES, *fa_kernel.BWD_SOURCES, *wkv_kernel.SOURCES,
                *scan_kernel.BWD_SOURCES):
        if src.name.endswith("_sm90.cu") or src.name == "rglru_scan_bwd.cu":
            assert '#include "sm90.cuh"' in src.read_text(), src.name


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_every_compile_gets_the_shared_include(nvcc, name):
    BUILDS[name]()
    compiles = [c for c in nvcc if "-c" in c]
    assert compiles
    for cmd in compiles:
        i = cmd.index("-I")
        assert Path(cmd[i + 1]) == build_mod.SHARED_INCLUDE


def test_a_change_to_the_shared_header_rebuilds_every_library(nvcc, tmp_path, monkeypatch):
    """Each library's file name changes with the shared header's bytes, and
    a library built against the old header is not taken for the new one."""
    shared = tmp_path / "csrc"
    shared.mkdir()
    header = shared / "sm90.cuh"
    header.write_text((build_mod.SHARED_INCLUDE / "sm90.cuh").read_text())
    monkeypatch.setattr(build_mod, "SHARED_INCLUDE", shared)
    before = {name: build().path.name for name, build in BUILDS.items()}
    assert {name: build().path.name for name, build in BUILDS.items()} == before
    n_commands = len(nvcc)
    header.write_text(header.read_text() + "\n// changed\n")
    after = {name: build().path.name for name, build in BUILDS.items()}
    assert all(after[name] != before[name] for name in BUILDS)
    assert len(nvcc) > n_commands  # built again, not loaded
