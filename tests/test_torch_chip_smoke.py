"""The checks of chip_smoke.py that need no GPU: the build's ptxas check on the
flash kernel's tensor-core route, and device_ms's check that the card ran
the timed calls back to back."""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

WGMMA_128 = "_ZN60_GLOBAL__N__ae5e_14attn_fwd_wgmmaILi128ELi128ELi128EEEvNS_4ArgsE14CUtensorMap_st"
WGMMA_256 = "_ZN60_GLOBAL__N__ae5e_14attn_fwd_wgmmaILi256ELi256ELi64EEEvNS_4ArgsE14CUtensorMap_st"
SIMT_128 = "_ZN55_GLOBAL__N__0a7c_8attn_fwdIfLi128ELi128ELi64ELi32EEEvNS_6ParamsE"


def _entry(name, stores=0, loads=0, registers=168):
    return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {name}\n"
            f"    0 bytes stack frame, {stores} bytes spill stores, {loads} bytes spill loads\n"
            f"ptxas info    : Used {registers} registers, used 1 barriers\n")


def _log(*entries):
    return ("ptxas info    : (C7519) warpgroup.arrive is injected in around line 2907 by "
            f"compiler to allow use of registers in GMMA in function '{WGMMA_128}'\n"
            + "".join(entries))


def test_ptxas_check_passes_a_clean_build():
    assert chip_smoke.wgmma_ptxas_faults(_log(_entry(SIMT_128), _entry(WGMMA_256),
                                              _entry(WGMMA_128))) == (2, [])


@pytest.mark.parametrize("stores, loads", [(612, 0), (0, 612), (8, 8)])
def test_ptxas_check_finds_a_spill_on_the_tensor_core_route(stores, loads):
    seen, faults = chip_smoke.wgmma_ptxas_faults(
        _log(_entry(WGMMA_256, stores, loads), _entry(WGMMA_128)))
    assert seen == 2
    assert len(faults) == 1 and faults[0].startswith(WGMMA_256)


def test_ptxas_check_leaves_a_simt_spill_alone():
    assert chip_smoke.wgmma_ptxas_faults(
        _log(_entry(SIMT_128, 16, 16), _entry(WGMMA_256), _entry(WGMMA_128))) == (2, [])


@pytest.mark.parametrize("code", ["C7512", "C7513", "C7515"])
def test_ptxas_check_finds_serialized_wgmma(code):
    note = (f"ptxas warning : ({code}) Potential Performance Loss: wgmma.mma_async "
            f"instructions are serialized due to ... in the function '{WGMMA_256}'\n")
    seen, faults = chip_smoke.wgmma_ptxas_faults(_log(note, _entry(WGMMA_256), _entry(WGMMA_128)))
    assert seen == 2 and faults == [note.strip()]


def test_ptxas_check_counts_the_instantiations():
    assert chip_smoke.wgmma_ptxas_faults(_log(_entry(SIMT_128), _entry(WGMMA_128)))[0] == 1


class _Card:
    """Stands in for the stream: each timed run's start event is still
    pending (held) or already reached when the last call was queued, as
    scripted, and each run's events are ms apart."""

    def __init__(self, monkeypatch, held, ms):
        self.held, self.ms, self.sleeps, self.calls = list(held), ms, [], 0
        card = self

        class Event:
            def __init__(self, enable_timing):
                assert enable_timing

            def record(self):
                pass

            def query(self):
                return not card.held.pop(0)

            def synchronize(self):
                pass

            def elapsed_time(self, end):
                return card.ms

        monkeypatch.setattr(torch.cuda, "Event", Event)
        monkeypatch.setattr(torch.cuda, "_sleep", self.sleeps.append, raising=False)
        monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
        monkeypatch.setattr(chip_smoke, "log", lambda msg: None)

    def fn(self):
        self.calls += 1


def test_device_ms_divides_a_held_run_by_its_calls(monkeypatch):
    card = _Card(monkeypatch, held=[True], ms=2.0)
    assert chip_smoke.device_ms(card.fn, 20) == pytest.approx(0.1)
    assert card.sleeps == [chip_smoke.SLEEP_CYCLES]
    assert card.calls == 1 + 20  # one warm-up call, then the timed run


def test_device_ms_takes_a_run_again_with_a_longer_sleep(monkeypatch):
    card = _Card(monkeypatch, held=[False, False, True], ms=1.0)
    assert chip_smoke.device_ms(card.fn, 10) == pytest.approx(0.1)
    assert card.sleeps == [chip_smoke.SLEEP_CYCLES * 4**i for i in range(3)]
    assert card.calls == 1 + 3 * 10


def test_device_ms_raises_when_no_run_was_held(monkeypatch):
    card = _Card(monkeypatch, held=[False] * chip_smoke.SLEEP_TRIES, ms=1.0)
    with pytest.raises(AssertionError, match="were not queued"):
        chip_smoke.device_ms(card.fn, 10)
    assert len(card.sleeps) == chip_smoke.SLEEP_TRIES


@pytest.mark.parametrize("n_layers, want_fwd", [(28, 77), (2, 5), (8, 23), (6, 15)])
def test_train_launch_counts_follow_the_remat_groups(n_layers, want_fwd):
    """3 L - L / k forward launches (k the remat group), L backward: the
    counts tests/test_torch_train.py measures with counting stand-ins."""
    want = dict.fromkeys(chip_smoke.KERNELS, 0)
    want.update(flash_attention_fwd=want_fwd, flash_attention_bwd=n_layers)
    assert chip_smoke.train_launches(n_layers) == want


def test_backward_bound_at_qwen3_train_shape():
    """Five products of 2 x 128 FLOP a visible pair: 8.6e10 FLOP, 0.087 ms at
    989 TFLOP/s; 0.104 ms with stage (a)'s recompute of Q K^T."""
    bound_ms, bound_by, flops, nbytes, with_a_ms = chip_smoke.bwd_bound(
        chip_smoke.QWEN3_TRAIN, torch.bfloat16)
    pairs = 8 * 16 * 1024 * 1025 // 2
    assert chip_smoke.visible_pairs(chip_smoke.QWEN3_TRAIN) == pairs
    assert flops == 2 * pairs * 5 * 128 == 85_983_232_000
    assert nbytes == 2 * (2 * 8 * 1024 * 16 * 256 + 2 * 8 * 1024 * 8 * 256)
    assert bound_by == "operations"
    assert abs(bound_ms - 0.0869) < 1e-4 and abs(with_a_ms - 0.1043) < 1e-4


def test_backward_cases_cover_the_masks_at_supported_head_dims():
    cases = chip_smoke.BWD_CASES
    assert chip_smoke.QWEN3_TRAIN in cases
    assert all((c[5], c[6]) in chip_smoke.fa_kernel.BWD_HEAD_DIMS for c in cases)
    assert any(c[8] is not None for c in cases)             # a window
    assert any(c[9] and c[4] < c[3] for c in cases)         # q_offset with GQA
    assert any(c[10] == 0 for c in cases)                   # kv_len 0
    assert any(c[1] != c[2] for c in cases)                 # ragged lengths
