"""The port stands alone: it imports nothing of JAX or of ``repro``, runs with
both blocked, and never falls back to the CPU when the GPU was asked for."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import resolve_device
from repro_torch import serve
from repro_torch.launch import train
from repro_torch.configs import get_config
from repro_torch.models import lm

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "repro")
BLOCK = ("import sys; sys.modules.update(dict.fromkeys(('jax', 'jaxlib', 'repro'))); "
         "sys.argv = [{argv}]; import runpy; "
         "runpy.run_module({module!r}, run_name='__main__', alter_sys=True)")


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _banned(module):
    return any(module == b or module.startswith(b + ".") for b in BANNED)


def test_banned_match_is_exact():
    assert _banned("repro") and _banned("repro.models.lm") and _banned("jax.numpy")
    assert not _banned("repro_torch") and not _banned("repro_torch.models")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_repro(path):
    bad = sorted(m for m in _imported_modules(path) if _banned(m))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src")}


def test_serve_runs_with_jax_and_repro_blocked():
    argv = "'repro_torch.serve', '--reduced', '--device', 'cpu'"
    proc = subprocess.run([sys.executable, "-c", BLOCK.format(argv=argv,
                                                               module="repro_torch.serve")],
                          capture_output=True, text=True, env=_env(), timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("[serve] prefill 4x24 in ")
    assert lines[1].startswith("[serve] decoded 16 tokens/seq x 4 seqs in ")
    assert lines[2].startswith("[serve] sample: [")


def test_train_runs_with_jax_and_repro_blocked(tmp_path):
    argv = ("'repro_torch.launch.train', '--arch', 'qwen3-1.7b', '--reduced', '--device', "
            f"'cpu', '--steps', '2', '--log-every', '1', '--ckpt-dir', '{tmp_path}'")
    proc = subprocess.run([sys.executable, "-c",
                           BLOCK.format(argv=argv, module="repro_torch.launch.train")],
                          capture_output=True, text=True, env=_env(), timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("[train] arch=qwen3-1.7b params=")
    assert lines[0].endswith("backend=cpu")
    assert lines[1].startswith("[train] step     1 loss=")
    assert lines[2].startswith("[train] step     2 loss=")
    assert lines[3].startswith("[train] done: ")
    assert (tmp_path / "step_00000002" / "arrays.npz").exists()


def test_train_without_device_raises_when_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present, so the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "qwen3-1.7b", "--reduced", "--steps", "1"])


def test_serve_without_device_raises_when_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present, so the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced"])


def test_entry_points_default_to_cuda_and_never_fall_back():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present, so the default device is valid")
    cfg = get_config("qwen3-1.7b").reduced()
    for call in (lambda: resolve_device(),
                 lambda: lm.init_params(cfg, torch.Generator().manual_seed(0)),
                 lambda: lm.init_cache(cfg, 1, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_away_from_the_checkout(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(lone)], capture_output=True, text=True,
                          cwd=tmp_path, timeout=120,
                          env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_dryrun_runs_with_jax_and_repro_blocked(tmp_path):
    """The dry-run's CLI on one reduced cell on a CPU mesh (the plain
    versions), over the fake group of 256 ranks it starts itself."""
    argv = ("'repro_torch.launch.dryrun', '--arch', 'qwen3-1.7b', '--shape', 'decode_32k', "
            f"'--reduced', '--device', 'cpu', '--out', '{tmp_path}', '--tag', 't'")
    proc = subprocess.run([sys.executable, "-c",
                           BLOCK.format(argv=argv, module="repro_torch.launch.dryrun")],
                          capture_output=True, text=True, env=_env(), timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("[ok   ] qwen3-1.7b x decode_32k x pod16x16 dom=")
    rec = (tmp_path / "t" / "qwen3-1.7b__decode_32k__pod16x16.json").read_text()
    assert '"device": "cpu"' in rec and '"kernels": "the plain versions"' in rec


SCHED_CELL = ("import sys; sys.modules.update(dict.fromkeys(('jax', 'jaxlib', 'repro'))); "
              "from repro_torch.configs import ARCHS; "
              "from repro_torch.core import ClusterSimulator, ClusterTopology, CommModel, "
              "make_batch_trace; "
              "from repro_torch.core.policies import make_policy; "
              "archs = list(ARCHS.values()); "
              "sim = ClusterSimulator(ClusterTopology(n_racks=2), make_policy('dally'), "
              "CommModel.from_configs(archs)); "
              "[sim.submit(j) for j in make_batch_trace(archs, n_jobs=60, seed=0)]; "
              "r = sim.run(); print(r['n_finished'], r['makespan'] > 0)")


def test_scheduler_runs_with_jax_and_repro_blocked():
    """A port scheduler cell (model_skew walks the port's schema) on its
    default profile, with jax and repro unimportable."""
    proc = subprocess.run([sys.executable, "-c", SCHED_CELL], capture_output=True, text=True,
                          env=_env(), timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines() == ["60 True"]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_holds_no_tpu_profile(path):
    assert "TPU_V5E" not in path.read_text()


def test_service_runs_with_jax_and_repro_blocked(tmp_path):
    """The daemon's CLI drains a small inbox on "smoke" and writes its
    artifact, with jax and repro unimportable."""
    import json
    inbox = tmp_path / "inbox"
    inbox.mkdir()
    for i, model in enumerate(("yi-9b", "qwen3-1.7b", "rwkv6-7b")):
        (inbox / f"job-{i}.json").write_text(json.dumps(
            {"name": f"job-{i}", "model": model, "n_gpus": 2 ** i, "gpu_hours": 0.5,
             "arrival": i * 300.0}))
    argv = (f"'repro_torch.service', '--state-dir', '{tmp_path / 'state'}', '--inbox', "
            f"'{inbox}', '--scenario', 'smoke', '--tick-sleep', '0', '--exit-when-idle'")
    proc = subprocess.run([sys.executable, "-c",
                           BLOCK.format(argv=argv, module="repro_torch.service")],
                          capture_output=True, text=True, env=_env(), timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith(f"final artifact: {tmp_path / 'state' / 'artifact.json'} "
                                  "(n_finished=3 makespan=")
    art = json.loads((tmp_path / "state" / "artifact.json").read_text())
    assert art["schema"] == "repro.service.artifact/v1" and art["n_submitted"] == 3


def test_sweep_list_runs_with_jax_and_repro_blocked():
    from repro_torch.experiments import SCENARIOS
    argv = "'repro_torch.experiments.sweep', '--list'"
    proc = subprocess.run([sys.executable, "-c",
                           BLOCK.format(argv=argv, module="repro_torch.experiments.sweep")],
                          capture_output=True, text=True, env=_env(), timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert [line.split()[0] for line in proc.stdout.splitlines()] == sorted(SCENARIOS)
