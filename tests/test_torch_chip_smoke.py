"""The checks of chip_smoke.py that need no GPU: the build's ptxas check on the
flash kernel's tensor-core route, device_ms's check that the card ran the
timed calls back to back, and the profiler's per-launch average."""
import inspect
import math
import re
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from repro_torch.optim import cosine_schedule, init_train_state  # noqa: E402

WGMMA_128 = "_ZN60_GLOBAL__N__ae5e_14attn_fwd_wgmmaILi128ELi128ELi128EEEvNS_4ArgsE14CUtensorMap_st"
WGMMA_256 = "_ZN60_GLOBAL__N__ae5e_14attn_fwd_wgmmaILi256ELi256ELi64EEEvNS_4ArgsE14CUtensorMap_st"
SIMT_128 = "_ZN55_GLOBAL__N__0a7c_8attn_fwdIfLi128ELi128ELi64ELi32EEEvNS_6ParamsE"
BWD_DKDV = ("_ZN60_GLOBAL__N__e9e9_19attn_bwd_dkdv_wgmmaILi256EEEvNS_4ArgsE14CUtensorMap_stS2_"
            "S2_S2_S2_S2_")
BWD_DQ = "_ZN60_GLOBAL__N__e9e9_17attn_bwd_dq_wgmmaILi256EEEvNS_4ArgsE14CUtensorMap_stS2_S2_S2_"
SIMT_BWD = ("_ZN55_GLOBAL__N__77aa_13attn_bwd_dkdvI13__nv_bfloat16Li128ELi128ELi32ELi32EEEv"
            "NS_6ParamsE")


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


@pytest.mark.parametrize("stores, loads, note", [(96, 96, None), (0, 0, "C7515"),
                                                 (0, 0, "C7520")])
def test_ptxas_check_finds_a_fault_in_a_backward_instantiation(stores, loads, note):
    """The backward library's log: its two tensor-core kernels count as
    instantiations, a spill in either or a serialized-wgmma note fails, a
    spill in a SIMT kernel does not."""
    clean = _log(_entry(SIMT_BWD, 32, 32), _entry(BWD_DQ), _entry(BWD_DKDV))
    assert chip_smoke.wgmma_ptxas_faults(clean) == (2, [])
    text = (f"ptxas warning : ({note}) Potential Performance Loss: wgmma.mma_async "
            f"instructions are serialized due to ... in the function '{BWD_DKDV}'\n"
            if note else "")
    seen, faults = chip_smoke.wgmma_ptxas_faults(
        _log(text, _entry(SIMT_BWD), _entry(BWD_DQ, stores, loads), _entry(BWD_DKDV)))
    assert seen == 2 and len(faults) == 1
    assert faults[0].startswith(BWD_DQ) if stores else note in faults[0]


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
    989 TFLOP/s; the bytes of q, k, v, o, dout, the f32 lse and the three
    gradients take 0.060 ms."""
    bound_ms, bound_by, flops, nbytes = chip_smoke.bwd_bound(chip_smoke.QWEN3_TRAIN,
                                                            torch.bfloat16)
    pairs = 8 * 16 * 1024 * 1025 // 2
    assert chip_smoke.visible_pairs(chip_smoke.QWEN3_TRAIN) == pairs
    assert flops == 2 * pairs * 5 * 128 == 85_983_232_000
    assert nbytes == 2 * (2 * 8 * 1024 * 16 * 256 + 2 * 8 * 1024 * 8 * 256) + 4 * 8 * 16 * 1024
    assert bound_by == "operations"
    assert abs(bound_ms - 0.0869) < 1e-4


def test_backward_cases_cover_the_masks_at_supported_head_dims():
    cases = chip_smoke.BWD_CASES
    assert chip_smoke.QWEN3_TRAIN in cases
    assert (2, 250, 333, 8, 2, 128, 128, True, 150, 83, 300) in cases
    assert (1, 64, 64, 4, 2, 128, 128, False, None, 0, 0) in cases
    assert all((c[5], c[6]) in chip_smoke.fa_kernel.BWD_HEAD_DIMS for c in cases)
    assert any(c[8] is not None for c in cases)             # a window
    assert any(c[9] and c[4] < c[3] for c in cases)         # q_offset with GQA
    assert any(c[10] == 0 for c in cases)                   # kv_len 0
    assert any(c[1] != c[2] for c in cases)                 # ragged lengths


def test_ms_a_launch_divides_by_the_launches_recorded():
    """The profiler may miss launches: 4 recorded launches of 0.2 ms in 5
    calls give 0.2 ms a launch, not 0.16; a session that recorded no launch
    of a kernel is taken again, and PROFILE_TRIES such sessions raise."""
    from types import SimpleNamespace as Event

    def session(delta, dkdv):
        return [Event(key="void attn_bwd_delta<__nv_bfloat16>(...)", count=delta,
                      self_device_time_total=delta * 30.0),
                Event(key="attn_bwd_dkdv_wgmma(Args, CUtensorMap...)", count=dkdv,
                      self_device_time_total=dkdv * 200.0),
                Event(key="nvjet_tst_192x192", count=9, self_device_time_total=9e3)]
    symbols = {"delta": "attn_bwd_delta", "dkdv": "attn_bwd_dkdv_wgmma"}
    sessions = iter([session(0, 5), session(4, 4)])
    ms = chip_smoke.ms_a_launch(lambda: next(sessions), symbols, calls=5)
    assert ms == pytest.approx({"delta": 0.03, "dkdv": 0.2})
    with pytest.raises(AssertionError, match="no launch of one of"):
        chip_smoke.ms_a_launch(lambda: session(5, 0), symbols, calls=5)


def test_backward_bound_at_recurrentgemma_train_shape_of_10_heads():
    """The step's shape, 10 heads: 10/16 of the pairs and FLOP of 16 heads,
    0.326 ms."""
    case = chip_smoke.RECURRENTGEMMA_TRAIN_10H
    bound_ms, bound_by, flops, _ = chip_smoke.bwd_bound(case, torch.bfloat16)
    assert chip_smoke.visible_pairs(case) * 16 == 201_359_360 * 10
    assert flops == 2 * 125_849_600 * 5 * 256
    assert bound_by == "operations" and abs(bound_ms - 0.3258) < 1e-4


def test_train_paths_time_recurrentgemma_at_the_step_heads_and_at_16():
    """The backward's and the forward's timed paths: recurrentgemma at the 10
    heads its train step and its serve launch; the backward also at 16
    heads beside it, to compare with the SIMT route's time there."""
    assert chip_smoke.BWD_PATHS["recurrentgemma-2b"][0] == chip_smoke.RECURRENTGEMMA_TRAIN_10H
    assert chip_smoke.BWD_AT_16_HEADS[0] == chip_smoke.RECURRENTGEMMA_TRAIN
    assert chip_smoke.FLASH_PATHS["recurrentgemma-2b"] == chip_smoke.RECURRENTGEMMA_PREFILL_10H
    assert set(chip_smoke.FLASH_PATHS) == set(chip_smoke.FLASH_ITERS) == set(chip_smoke.BWD_PATHS)


def test_forward_cases_take_the_shapes_the_main_paths_launch():
    """The forward is held to its plain version and lse_reference at the
    shapes recurrentgemma's serve and train step launch (10 heads), and
    those forward-only shapes stay out of the backward's cases, which take
    the train shape once, in their own place."""
    cases = chip_smoke.KERNEL_CASES
    for case in (chip_smoke.RECURRENTGEMMA_PREFILL_10H, chip_smoke.RECURRENTGEMMA_TRAIN_10H,
                 chip_smoke.QWEN3_PREFILL):
        assert case in cases
        assert chip_smoke.fa_kernel.route(torch.bfloat16, case[5], case[6]) == "wgmma"
    assert chip_smoke.RECURRENTGEMMA_PREFILL_10H[3] == chip_smoke.RECURRENTGEMMA_TRAIN_10H[3] == 10
    assert chip_smoke.RECURRENTGEMMA_PREFILL_10H[:3] == (8, 4096, 4096)
    assert chip_smoke.RECURRENTGEMMA_TRAIN_10H[:3] == (2, 4096, 4096)
    bwd = chip_smoke.BWD_CASES
    assert chip_smoke.RECURRENTGEMMA_PREFILL_10H not in bwd
    assert bwd.count(chip_smoke.RECURRENTGEMMA_TRAIN_10H) == 1
    assert len(set(bwd)) == len(bwd)


@pytest.mark.parametrize("name", [
    "void (anonymous namespace)::attn_bwd_dkdv_wgmma<256>(Args, CUtensorMap_st, CUtensorMap_st)",
    "void (anonymous namespace)::attn_bwd_dq_wgmma<128>(Args, CUtensorMap_st)",
    "void (anonymous namespace)::attn_bwd_dkdv<float, 256, 256, 16, 16>(Params)"])
def test_profiler_names_of_the_backward_kernels_are_the_ports(name):
    """The tensor-core backward's kernels are templates on the head dim, so
    the profiler prints their template arguments ("<"), as it does the SIMT
    kernels'."""
    assert name.startswith(chip_smoke.PORT_KERNEL_SYMBOLS)


def test_backward_bound_at_recurrentgemma_train_shape():
    """16 heads over 2 x 4096 queries, each seeing min(i + 1, 2048) keys:
    201,359,360 pairs, five products of 2 x 256 FLOP a pair, 0.521 ms at 989
    TFLOP/s; the bytes take 0.085 ms."""
    case = chip_smoke.RECURRENTGEMMA_TRAIN
    bound_ms, bound_by, flops, nbytes = chip_smoke.bwd_bound(case, torch.bfloat16)
    pairs = 2 * 16 * (2048 * 2049 // 2 + 2048 * 2048)
    assert chip_smoke.visible_pairs(case) == pairs == 201_359_360
    assert flops == 2 * pairs * 5 * 256
    assert nbytes == 2 * (2 * 2 * 4096 * 16 * 512 + 2 * 2 * 4096 * 512) + 4 * 2 * 16 * 4096
    assert bound_by == "operations" and abs(bound_ms - 0.5212) < 1e-4


def test_scan_backward_bound_at_train_shape():
    """dh, a and h read, da and db written (20 bytes an element in f32) and
    dh0: 0.125 ms at 3.35 TB/s."""
    bound_ms, bound_by, flops, nbytes = chip_smoke.scan_bwd_bound(chip_smoke.SCAN_TRAIN_CASE,
                                                                 torch.float32)
    assert nbytes == 20 * 2 * 4096 * 2560 + 4 * 2 * 2560
    assert flops == 3 * 2 * 4096 * 2560
    assert bound_by == "bytes" and abs(bound_ms - 0.1252) < 1e-4


def test_hybrid_train_launches_at_full_depth():
    """recurrentgemma-2b's 8 attention and 18 RG-LRU layers, each its own
    checkpoint: the counts tests/test_torch_train.py measures; on the card in
    bf16 the forward and the backward at head dim 256 take the tensor
    cores."""
    cfg = chip_smoke.get_config("recurrentgemma-2b")
    want = chip_smoke.want_train_launches(cfg, torch.bfloat16)
    assert {k: want[k] for k in chip_smoke.KERNELS} == {
        "flash_attention_fwd": 16, "flash_attention_bwd": 8, "rwkv6_wkv_fwd": 0,
        "rglru_scan_fwd": 36, "rglru_scan_bwd": 18, "rwkv6_wkv_bwd": 0}
    assert want["flash_attention_fwd by route"] == {"wgmma": 16, "simt": 0}
    assert want["flash_attention_bwd by route"] == {"wgmma": 8, "simt": 0}
    assert want["flash_attention_fwd with lse"] == 16
    assert want["rglru_scan_bwd by route"] == {"tma": 18, "prefetch": 0}
    qwen = chip_smoke.want_train_launches(chip_smoke.get_config("qwen3-1.7b"), torch.float32)
    assert {k: qwen[k] for k in chip_smoke.KERNELS} == chip_smoke.train_launches(28)
    assert qwen["flash_attention_bwd by route"] == {"wgmma": 0, "simt": 28}


def test_spill_check_of_this_slice_kernels():
    simt_256 = ("_ZN55_GLOBAL__N__62be_13attn_bwd_dkdvI13__nv_bfloat16Li256ELi256ELi16ELi16EEE"
                "vNS_6ParamsE")
    simt_128 = "_ZN55_GLOBAL__N__62be_11attn_bwd_dqIfLi128ELi128ELi64ELi32EEEvNS_6ParamsE"
    pattern = r"attn_bwd_(dkdv|dq)I.*Li256ELi256E"
    text = _log(_entry(simt_256), _entry(simt_128, 16, 16))
    assert chip_smoke.spilling_entries(text, pattern) == (1, [])
    seen, spills = chip_smoke.spilling_entries(_log(_entry(simt_256, 0, 8)), pattern)
    assert seen == 1 and len(spills) == 1 and spills[0].startswith(simt_256)


def test_backward_cases_take_recurrentgemma_train_shape():
    """At the 10 heads the step launches and at 16 with 6 padded (dout 0),
    every bf16 case at 256 on the tensor cores."""
    cases = chip_smoke.BWD_CASES
    assert chip_smoke.RECURRENTGEMMA_TRAIN in cases and chip_smoke.RECURRENTGEMMA_TRAIN_10H in cases
    assert chip_smoke.RECURRENTGEMMA_TRAIN_10H[3] == 10
    assert chip_smoke.RECURRENTGEMMA_TRAIN_10H[:3] + chip_smoke.RECURRENTGEMMA_TRAIN_10H[4:] == \
        chip_smoke.RECURRENTGEMMA_TRAIN[:3] + chip_smoke.RECURRENTGEMMA_TRAIN[4:]
    assert chip_smoke.BWD_REAL_HEADS[chip_smoke.RECURRENTGEMMA_TRAIN] == 10
    assert chip_smoke.RECURRENTGEMMA_PREFILL not in cases  # batch 8: its serve shape
    assert chip_smoke.RECURRENTGEMMA_PREFILL_10H not in cases
    assert set(chip_smoke.BWD_REAL_HEADS) <= set(cases)
    at_256 = [c for c in cases if c[5:7] == (256, 256)]
    assert any(c[8] is not None and c[9] and c[1] % 16 for c in at_256)  # tile edges
    assert any(c[10] == 0 for c in at_256)
    assert all(fa_route(c) == "wgmma" for c in at_256)


def fa_route(case):
    return chip_smoke.fa_kernel.route(torch.bfloat16, case[5], case[6], backward=True)


def _first_steps(pairs):
    """Two paths' masters after one AdamW step, as make_train_step takes it,
    from the same state: leaf "w" starts at 0.05, leaf "z" at zero.  Each
    path's gradients are one of each pair (bf16, both leaves alike), with a
    3.0 that makes the clip factor about 1/4.3, so 3e-8 is near eps."""
    out = []
    for side in (0, 1):
        g = torch.tensor([3.0] + [p[side] for p in pairs], dtype=torch.bfloat16)
        params = {"w": torch.full_like(g, 0.05), "z": torch.zeros_like(g)}
        seen = {}
        update = chip_smoke.first_step_seen(seen)
        state, _ = update(init_train_state(params), [g, g.clone()],
                          lr=cosine_schedule(3e-4, 100, 10_000), clip=1.0, weight_decay=0.1)
        out.append((state["master"], seen))
    return out


PAIRS = [(1e-3, 1.1e-3), (3e-8, 1e-8), (-1e-5, 1e-5), (2e-9, -4e-9), (0.0, 5e-8), (5e-4, 4e-4)]


def test_first_step_excess_holds_adamws_own_steps():
    """Every element, however near eps its clipped gradient or whichever way
    it flips, lies within f32 rounding of the two first steps' difference;
    in the leaf that starts at zero that difference is far more than 2e-2."""
    (mk, sk), (mp, sp) = _first_steps(PAIRS)
    for i, leaf in enumerate(("w", "z")):
        over, worst = chip_smoke.first_step_excess(mk[leaf], mp[leaf], sk, sp, i, chunk=3)
        assert over == 0 and worst <= 1
    assert chip_smoke.rel_err(mk["z"], mp["z"]) > 0.1


@pytest.mark.parametrize("leaf, element", [(0, 2), (1, 2), (1, 6)])
def test_first_step_excess_finds_a_wrong_master(leaf, element):
    """A master element moved by a hundredth of the step's lr is found, in
    a leaf at 0.05 (where that is 8 ulps) and in one at zero."""
    (mk, sk), (mp, sp) = _first_steps(PAIRS)
    a = chip_smoke.leaves(mk)[leaf].clone()
    a[element] += 1e-2 * sk["lr"]
    over, worst = chip_smoke.first_step_excess(a, chip_smoke.leaves(mp)[leaf], sk, sp, leaf)
    assert over == 1 and worst > 1


def test_sign_flips_counts_small_flips_and_refuses_a_large_one():
    gk, gp = (torch.tensor(v, dtype=torch.bfloat16) for v in ([1.0, -1e-3, 0.5], [1.0, 1e-3, 0.5]))
    n, ratio = chip_smoke.sign_flips(gk, gp, 2e-2)
    assert n == 1 and ratio == pytest.approx(1e-3, rel=1e-2)
    gk, gp = (torch.tensor(v, dtype=torch.bfloat16) for v in ([1.0, -0.05], [1.0, 0.05]))
    with pytest.raises(AssertionError, match="changes sign"):
        chip_smoke.sign_flips(gk, gp, 2e-2)


def test_wkv_cases_hold_every_route_and_the_new_edges():
    """In bf16 the chunk route takes every case at head dim 64 with T >= 2:
    the ragged (2, 37, 4, 64), the prefill shape with both decays, a ragged
    T over two chunks with s0, and the edge case; the decode shape (T = 1)
    and the smaller head dims stay recurrent, as every f32 case does."""
    route = chip_smoke.wkv_kernel.route
    chunk = [c for c in chip_smoke.WKV_CASES if route(torch.bfloat16, c[3], c[1]) == "chunk"]
    assert (2, 37, 4, 64, True, "sigmoid") in chunk
    assert (2, 100, 8, 64, True, "model") in chunk
    assert chip_smoke.WKV_PREFILL_CASE in chunk and (8, 1024, 64, 64, False, "model") in chunk
    assert any(c[5] == "edges" for c in chunk)
    assert route(torch.bfloat16, 64, chip_smoke.WKV_DECODE_CASE[1]) == "recurrent"
    assert all(route(torch.float32, c[3], c[1]) == "recurrent" for c in chip_smoke.WKV_CASES)
    assert chip_smoke.WKV_DECODE_CASE[1] == 1 and chip_smoke.WKV_PREFILL_CASE[:4] == (
        8, 1024, 64, 64)


def test_wkv_grad_cases_are_the_shapes_training_gives_the_recurrent_route():
    """The forward of a gradient is held against the plain version at the
    train slice's shape and the main train path's (model decay, no s0), and
    at WKV_CASES' edge case, on the route training gives it: chunk_exact in
    bf16, recurrent in f32."""
    arch, cut, batch, seq, _ = next(s for s in chip_smoke.TRAIN_SLICES if s[0] == "rwkv6-7b")
    cfg = chip_smoke.get_config(arch)
    heads = (cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim)
    want = {(batch, seq, *heads), (*chip_smoke.TRAIN_SHAPES[arch], *heads)}
    train = [c for c in chip_smoke.WKV_GRAD_CASES if c[5] == "model"]
    assert {c[:4] for c in train} == want
    assert all(c[4:] == (False, "model") for c in train)
    edge = next(c for c in chip_smoke.WKV_CASES if c[5] == "edges")
    assert chip_smoke.WKV_GRAD_CASES == train + [edge]
    route = chip_smoke.wkv_kernel.route
    assert all(route(torch.float32, c[3], c[1], grad=True) == "recurrent"
               for c in chip_smoke.WKV_GRAD_CASES)
    assert all(route(torch.bfloat16, c[3], c[1], grad=True) == "chunk_exact"
               for c in chip_smoke.WKV_GRAD_CASES)


def test_wkv_edge_case_forces_zero_one_and_deep_decays_inside_its_steps():
    edge = next(c for c in chip_smoke.WKV_CASES if c[5] == "edges")
    T = edge[1]
    steps = chip_smoke.WKV_EDGE_STEPS
    assert set(steps) == {0.0, 1.0, math.exp(-100.0)}
    assert all(any(t < T for t in ts) for ts in steps.values())
    assert T % 64 and T > 64                    # a ragged last chunk after a full one
    assert {0, 63, 64} <= set(steps[0.0])       # a chunk's first and last steps
    assert {15, 16} <= set(steps[1.0])          # both sides of a sub-chunk's edge


def test_rwkv6_serve_launches_by_route():
    """32 prefill launches (bf16, 1024 steps) in chunks, 63 decode steps of
    32 layers recurrent; the other served models launch no WKV."""
    routes = chip_smoke.SERVE_WKV_ROUTES
    assert routes["rwkv6-7b"] == {"chunk": 32, "chunk_exact": 0, "recurrent": 2016}
    assert sum(routes["rwkv6-7b"].values()) == chip_smoke.SERVE_LAUNCHES["rwkv6-7b"][
        "rwkv6_wkv_fwd"]
    assert all(r == {"chunk": 0, "chunk_exact": 0, "recurrent": 0}
               for a, r in routes.items() if a != "rwkv6-7b")


@pytest.mark.parametrize("dtype, want_fwd, want", [
    (torch.bfloat16, {"chunk": 2, "chunk_exact": 0, "recurrent": 0},
     {"chunk": 2, "chunk_exact": 0, "recurrent": 8}),
    (torch.float32, {"chunk": 0, "chunk_exact": 0, "recurrent": 2},
     {"chunk": 0, "chunk_exact": 0, "recurrent": 10})])
def test_rwkv6_slice_launches_by_route(dtype, want_fwd, want):
    """The 64-token slice at 2 layers: the train-mode forward and prefill in
    chunks in bf16, each of the 4 decode steps recurrent; f32 all recurrent."""
    arch, cut, prompt_len, _, fwd, launches = next(
        s for s in chip_smoke.SLICES if s[0] == "rwkv6-7b")
    cfg = chip_smoke.dataclasses.replace(chip_smoke.get_config(arch), **cut)
    n = fwd["rwkv6_wkv_fwd"]
    assert chip_smoke.wkv_routes(cfg, dtype, prompt_len, n, 0) == want_fwd
    got = chip_smoke.wkv_routes(cfg, dtype, prompt_len, n, n * chip_smoke.SLICE_DECODE_STEPS)
    assert got == want and sum(got.values()) == launches["rwkv6_wkv_fwd"]


@pytest.mark.parametrize("name", [
    "(anonymous namespace)::wkv_fwd_chunk((anonymous namespace)::Args, CUtensorMap_st)",
    "void (anonymous namespace)::wkv_fwd<__nv_bfloat16, 64>(Params)",
    "void (anonymous namespace)::rglru_bwd_tma<float>(float const*, float const*)",
    "void (anonymous namespace)::rglru_bwd<__nv_bfloat16>(__nv_bfloat16 const*)"])
def test_profiler_names_of_the_recurrence_kernels_are_the_ports(name):
    assert name.startswith(chip_smoke.PORT_KERNEL_SYMBOLS)


def test_spill_check_finds_the_chunk_route_kernel():
    chunk = ("_ZN54_GLOBAL__N__40cd4659_21_rwkv6_wkv_fwd_sm90_cu_b348a0ca13wkv_fwd_chunkENS_4Args"
             "E14CUtensorMap_stS1_S1_S1_")
    recurrent = ("_ZN49_GLOBAL__N__b056f199_16_rwkv6_wkv_fwd_cu_8869d4497wkv_fwdIfLi64EEEv"
                 "NS_6ParamsE")
    assert chip_smoke.spilling_entries(_log(_entry(recurrent), _entry(chunk)),
                                       "wkv_fwd_chunk") == (1, [])
    seen, spills = chip_smoke.spilling_entries(_log(_entry(chunk, 4, 4)), "wkv_fwd_chunk")
    assert seen == 1 and spills and spills[0].startswith(chunk)


def test_wkv_bound_at_the_prefill_shape():
    """r, k, v, w read and y written in bf16 (5 x 67.1 MB), s_last in f32:
    344 MB, 0.1027 ms at 3.35 TB/s."""
    bound_ms, bound_by, flops, nbytes, _ = chip_smoke.wkv_bound(chip_smoke.WKV_PREFILL_CASE,
                                                                torch.bfloat16)
    assert nbytes == 2 * 5 * 8 * 1024 * 64 * 64 + 4 * 64 * 64 + 4 * 8 * 64 * 64 * 64
    assert flops == 4 * 8 * 1024 * 64 * 64 * 64
    assert bound_by == "bytes" and abs(bound_ms - 0.1027) < 1e-4


def test_scan_backward_cases_take_every_route():
    """On whole allocations, as the cases' inputs are, the bf16 cases of W =
    100 (200-byte rows) take the prefetch route and every other case the TMA
    route, recurrentgemma-2b's train shape among them: the card's run checks
    each route against its plain version."""
    routes = {}
    for case in chip_smoke.SCAN_BWD_CASES:
        B, T, W = case[:3]
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.zeros(B, T, W, dtype=dtype)
            routes[W, dtype] = chip_smoke.scan_kernel.bwd_route(x, x, x)
    assert {r for r in routes.values()} == set(chip_smoke.scan_kernel.BWD_ROUTES)
    assert [k for k, r in routes.items() if r == "prefetch"] == [(100, torch.bfloat16)]
    assert routes[chip_smoke.SCAN_TRAIN_CASE[2], torch.float32] == "tma"


def test_serve_launches_of_the_dense_siblings_and_moe_models():
    """One flash launch a layer in prefill, on the tensor cores, none in
    decode: yi-9b 48, minitron-4b 32, qwen2-moe-a2.7b 24, qwen3-moe-30b-a3b 48."""
    want = {"yi-9b": 48, "minitron-4b": 32, "qwen2-moe-a2.7b": 24, "qwen3-moe-30b-a3b": 48}
    for arch, n in want.items():
        assert chip_smoke.SERVE_LAUNCHES[arch] == {**dict.fromkeys(chip_smoke.KERNELS, 0),
                                                   "flash_attention_fwd": n}
        assert chip_smoke.get_config(arch).n_layers == n
        assert chip_smoke.SERVE_FLASH_ROUTES[arch] == {"wgmma": n, "simt": 0}
        assert chip_smoke.SERVE_WKV_ROUTES[arch] == {"chunk": 0, "chunk_exact": 0,
                                                     "recurrent": 0}
        assert chip_smoke.SERVE_PROMPT[arch] == 1024


@pytest.mark.parametrize("arch, layers, fwd, bwd", [("minitron-4b", 26, 65, 26),
                                                     ("yi-9b", 16, 46, 16)])
def test_train_launches_at_the_cut_depths(arch, layers, fwd, bwd):
    """At 26 layers in remat groups of 2, 3 x 26 - 13 forward launches and
    26 backward; at 16 in groups of 8, 46 and 16; in bf16 all on the tensor
    cores, every forward writing the lse."""
    cfg = chip_smoke.dataclasses.replace(chip_smoke.get_config(arch),
                                         **chip_smoke.TRAIN_CUTS[arch])
    assert cfg.n_layers == layers and chip_smoke.TRAIN_SHAPES[arch] == (2, 4096)
    want = chip_smoke.want_train_launches(cfg, torch.bfloat16)
    assert (want["flash_attention_fwd"], want["flash_attention_bwd"]) == (fwd, bwd)
    assert want["flash_attention_fwd by route"] == {"wgmma": fwd, "simt": 0}
    assert want["flash_attention_bwd by route"] == {"wgmma": bwd, "simt": 0}
    assert want["flash_attention_fwd with lse"] == fwd


def test_new_shapes_join_the_kernel_and_backward_cases():
    """The prefill shapes of the new models (GQA groups of 8, 4 and 1) and
    yi-9b's and minitron-4b's train shapes, forward and backward, on the
    tensor cores in bf16; minitron's train shape with dout 0 on its 8
    padded heads."""
    new = (chip_smoke.YI_PREFILL, chip_smoke.MINITRON_PREFILL, chip_smoke.QWEN2_MOE_PREFILL,
           chip_smoke.YI_TRAIN, chip_smoke.MINITRON_TRAIN)
    assert [c[3] // c[4] for c in new] == [8, 4, 1, 8, 4]
    for case in new:
        assert case in chip_smoke.KERNEL_CASES and case in chip_smoke.BWD_CASES
        assert chip_smoke.fa_kernel.route(torch.bfloat16, case[5], case[6]) == "wgmma"
        assert fa_route(case) == "wgmma"
    assert chip_smoke.BWD_REAL_HEADS[chip_smoke.MINITRON_TRAIN] == 24
    assert len(set(chip_smoke.BWD_CASES)) == len(chip_smoke.BWD_CASES)
    assert chip_smoke.FLASH_PATHS["yi-9b"] == chip_smoke.YI_PREFILL
    assert chip_smoke.BWD_PATHS["yi-9b"][0] == chip_smoke.YI_TRAIN


def test_bounds_at_yi_9b_shapes():
    """4 x 8 x 32 x 128 x 524,800 FLOP at 989 TFLOP/s forward, 0.0696 ms;
    the backward's five products over 2 x 32 x 4096 x 4097 / 2 pairs,
    0.695 ms."""
    fwd_ms, fwd_by, fwd_flops, _ = chip_smoke.attention_bound(chip_smoke.YI_PREFILL,
                                                              torch.bfloat16)
    assert fwd_flops == 4 * 8 * 32 * 128 * 524_800
    assert fwd_by == "operations" and abs(fwd_ms - 0.0696) < 1e-4
    bwd_ms, bwd_by, bwd_flops, _ = chip_smoke.bwd_bound(chip_smoke.YI_TRAIN, torch.bfloat16)
    assert bwd_flops == 2 * (2 * 32 * 4096 * 4097 // 2) * 5 * 128
    assert bwd_by == "operations" and abs(bwd_ms - 0.695) < 1e-3


def _routing(probs_k, probs_p, top_k):
    """Each path's probabilities (tokens x experts) and its own top-k."""
    pk, pp = torch.tensor(probs_k), torch.tensor(probs_p)
    return pp, torch.topk(pp, top_k).indices, pk, torch.topk(pk, top_k).indices


def test_routing_differences_counts_near_ties():
    """Token 1's second and third experts swap between the paths: the plain
    path's gap there (0.002) is within the two experts' differences between
    the paths (0.0015 + 0.0015); token 0 agrees."""
    pp, ip, pk, ik = _routing([[0.5, 0.3, 0.2, 0.0], [0.4, 0.2995, 0.3005, 0.0]],
                              [[0.5, 0.3, 0.2, 0.0], [0.4, 0.301, 0.299, 0.0]], 2)
    n, worst = chip_smoke.routing_differences(pp, ip, pk, ik, 2)
    assert n == 1 and worst == pytest.approx(0.002 / 0.003, rel=1e-4)
    assert chip_smoke.routing_differences(pp, ip, pp, ip, 2) == (0, 0.0)


def test_routing_differences_refuses_a_difference_that_is_no_tie():
    """The plain path's second and third probabilities are 0.1 apart and
    the paths' probabilities differ by 0.001: a kernel path that chose the
    third expert made no near-tie."""
    pp, ip = torch.tensor([[0.5, 0.25, 0.15, 0.1]]), torch.tensor([[0, 1]])
    pk, ik = torch.tensor([[0.5, 0.249, 0.151, 0.1]]), torch.tensor([[0, 2]])
    with pytest.raises(AssertionError, match="gap"):
        chip_smoke.routing_differences(pp, ip, pk, ik, 2)


@pytest.mark.parametrize("norm", [True, False])
def test_router_replay_hands_the_plain_path_the_kernel_paths_experts(norm):
    """The plain path's call gets the kernel path's expert ids, in its
    order, and its own probabilities at them as gates (renormalised when the
    config says so); a near-tie between the paths' choices is counted."""
    moe_cfg = chip_smoke.get_config("qwen3-moe-30b-a3b").reduced().moe
    moe_cfg = chip_smoke.dataclasses.replace(moe_cfg, n_experts=4, top_k=2,
                                             router_norm_topk=norm)
    router = torch.eye(4)
    replay = chip_smoke.RouterReplay()
    y_k = torch.tensor([[[2.0, 1.0001, 1.0, 0.0]]])
    y_p = torch.tensor([[[2.0, 1.0, 1.0001, 0.0]]])
    _, idx_k, _ = replay.record(y_k, {"router": router}, moe_cfg)
    gates, idx, probs = replay.replay(y_p, {"router": router}, moe_cfg)
    assert idx_k.tolist() == [[[0, 1]]] and torch.equal(idx, idx_k)
    want = probs[..., [0, 1]]
    if norm:
        want = want / want.sum(-1, keepdim=True)
    assert torch.allclose(gates, want)
    assert replay.differ == [1] and replay.replayed == 1 and 0 < replay.worst <= 1
    with pytest.raises(AssertionError, match="more often"):
        replay.replay(y_p, {"router": router}, moe_cfg)


def test_kernels_line_lists_six_kernels_with_the_wkv_backward():
    """KERNELS and BUILDS name the six kernels, and main's kernels line has
    one entry for each, the WKV backward's from its own sources: the chunk
    route's, which the main path takes, as its source, and the recurrent
    route's beside it."""
    names = list(chip_smoke.KERNELS)
    assert len(names) == 6 and names[-1] == "rwkv6_wkv_bwd"
    assert list(chip_smoke.BUILDS) == names
    assert chip_smoke.BUILDS["rwkv6_wkv_bwd"] == chip_smoke.wkv_kernel.build_bwd
    src = inspect.getsource(chip_smoke.main)
    assert sorted(re.findall(r'"name": "(\w+)"', src)) == sorted(names)
    assert '"source": "src/repro_torch/kernels/rwkv6_wkv/csrc/rwkv6_wkv_bwd_sm90.cu"' in src
    assert '"recurrent": "src/repro_torch/kernels/rwkv6_wkv/csrc/rwkv6_wkv_bwd.cu"' in src
    for name in ("rwkv6_wkv_bwd_sm90.cu", "rwkv6_wkv_bwd.cu", "rwkv6_wkv_chain_sm90.cuh"):
        assert (Path(chip_smoke.__file__).parent / "src/repro_torch/kernels/rwkv6_wkv/csrc"
                / name).is_file()


def test_rwkv6_train_slice_runs_bf16_at_two_layers():
    """2 layers at full width, 2 x 200 tokens, bf16 only (ROADMAP C4), the
    WKV entry point swapped for the plain version on the plain path; its
    launches 5 forward, on the chunk_exact route as every bf16 forward of a
    gradient at head dim 64, and 2 backward, on the chunk route, in each
    part."""
    arch, cut, batch, seq, patches = next(s for s in chip_smoke.TRAIN_SLICES
                                          if s[0] == "rwkv6-7b")
    assert (cut, batch, seq) == ({"n_layers": 2}, 2, 200) and seq % 64
    assert patches == [(chip_smoke.rwkv6, "rwkv6_wkv", chip_smoke.wkv_ref.rwkv6_reference)]
    assert chip_smoke.TRAIN_SLICE_DTYPES["rwkv6-7b"] == ((torch.bfloat16, 2e-2),)
    cfg = chip_smoke.dataclasses.replace(chip_smoke.get_config(arch), **cut)
    want = chip_smoke.want_train_launches(cfg, torch.bfloat16, seq)
    assert {k: want[k] for k in chip_smoke.KERNELS} == {
        **dict.fromkeys(chip_smoke.KERNELS, 0), "rwkv6_wkv_fwd": 5, "rwkv6_wkv_bwd": 2}
    assert want["rwkv6_wkv_fwd by route"] == {"chunk": 0, "chunk_exact": 5, "recurrent": 0}
    assert want["rwkv6_wkv_bwd by route"] == {"chunk": 2, "recurrent": 0}
    assert want["flash_attention_fwd with lse"] == 0


def test_rwkv6_train_launches_at_the_cut_depth():
    """At the cut depth, 14 layers in remat groups of 2, 3 n - n / 2 WKV
    forward launches, all on the chunk_exact route (the forward of a
    gradient in bf16), and n backward, all on the chunk route; no flash and
    no scan."""
    cfg = chip_smoke.dataclasses.replace(chip_smoke.get_config("rwkv6-7b"),
                                         **chip_smoke.TRAIN_CUTS["rwkv6-7b"])
    n = cfg.n_layers
    k = next(g for g in (8, 4, 2, 1) if n % g == 0)
    assert (n, k) == (14, 2)
    assert chip_smoke.TRAIN_SHAPES["rwkv6-7b"] == (2, 4096)
    want = chip_smoke.want_train_launches(cfg, torch.bfloat16, 4096)
    assert {name: want[name] for name in chip_smoke.KERNELS} == {
        **dict.fromkeys(chip_smoke.KERNELS, 0), "rwkv6_wkv_fwd": 3 * n - n // k,
        "rwkv6_wkv_bwd": n}
    assert want["rwkv6_wkv_fwd by route"] == {"chunk": 0, "chunk_exact": 3 * n - n // k,
                                              "recurrent": 0}
    assert want["rwkv6_wkv_bwd by route"] == {"chunk": n, "recurrent": 0}
    assert chip_smoke.train_launches(n, kernels=chip_smoke.STACK_KERNELS["rwkv"]) == {
        name: want[name] for name in chip_smoke.KERNELS}


def test_train_launches_of_the_other_models_show_no_wkv():
    """The other train paths' tables read both WKV kernels' launches by
    route too, all 0; a run that launched nothing reads all 0."""
    for arch in ("qwen3-1.7b", "recurrentgemma-2b", "yi-9b"):
        want = chip_smoke.want_train_launches(chip_smoke.get_config(arch), torch.bfloat16, 64)
        assert want["rwkv6_wkv_fwd by route"] == {"chunk": 0, "chunk_exact": 0, "recurrent": 0}
        assert want["rwkv6_wkv_bwd by route"] == {"chunk": 0, "recurrent": 0}
        assert want["rwkv6_wkv_bwd"] == 0
    none = chip_smoke.no_train_launches()
    assert none.keys() == want.keys()
    assert none["rwkv6_wkv_bwd by route"] == {"chunk": 0, "recurrent": 0}


def test_wkv_backward_cases_cover_dims_raggedness_edges_and_the_train_shape():
    cases = chip_smoke.WKV_BWD_CASES
    C = chip_smoke.wkv_kernel.CHECKPOINT_STEPS
    assert {c[3] for c in cases} == {8, 16, 32, 64}
    assert any(c[1] % C and c[1] > C and c[3] == 64 for c in cases)
    assert any(c[1] == 1 for c in cases)
    assert {(c[4], c[5]) for c in cases if c[3] == 64} >= {(True, True), (False, False)}
    edge = next(c for c in cases if c[6] == "edges")
    assert all(any(t < edge[1] for t in ts) for ts in chip_smoke.WKV_EDGE_STEPS.values())
    assert chip_smoke.WKV_BWD_TRAIN_CASE == (2, 4096, 64, 64, False, False, "model")
    assert chip_smoke.WKV_BWD_REL_TOL[torch.float32] == dict.fromkeys(
        chip_smoke.WKV_BWD_OUTPUTS, 1e-5)
    assert chip_smoke.WKV_BWD_REL_TOL[torch.bfloat16] == {
        "dr": 2**-7, "dk": 2**-7, "dv": 2**-7, "dw": 2**-7, "du": 1e-5, "ds0": 1e-5}


def test_wkv_backward_bound_at_the_train_shape():
    """r, k, v, w and dy read and dr, dk, dv, dw written in bf16 (9 x 67.1
    MB), u and du, ds0 in f32: 606 MB, 0.1809 ms at 3.35 TB/s; 14 D^2 + 8 D
    FLOP a (b, h, t), 3.03e10, 0.0306 ms on the tensor cores: the bytes
    bound it; 0.4527 ms at the f32 rate beside it."""
    bound_ms, bound_by, flops, nbytes, f32_ms = chip_smoke.wkv_bwd_bound(
        chip_smoke.WKV_BWD_TRAIN_CASE, torch.bfloat16)
    B, T, H, D = 2, 4096, 64, 64
    assert nbytes == 2 * 9 * B * T * H * D + 8 * H * D + 4 * B * H * D * D
    assert flops == (14 * D * D + 8 * D) * B * T * H
    assert bound_by == "bytes" and abs(bound_ms - 0.1809) < 1e-4
    assert abs(f32_ms - 0.4527) < 1e-4


@pytest.mark.parametrize("name", [
    "void (anonymous namespace)::wkv_bwd_fwd<__nv_bfloat16, 64>((anonymous namespace)::Params)",
    "void (anonymous namespace)::wkv_bwd_rev<float, 64>((anonymous namespace)::Params)",
    "void (anonymous namespace)::wkv_bwd_du<64>(float const*, float*, int, int)"])
def test_profiler_names_of_the_wkv_backward_kernels_are_the_ports(name):
    assert name.startswith(chip_smoke.PORT_KERNEL_SYMBOLS)


def test_spill_check_finds_the_wkv_backward_kernels():
    rev = "_ZN49_GLOBAL__N__5d1c3e2a_16_rwkv6_wkv_bwd_cu_1a2b3c4d11wkv_bwd_revI13__nv_bfloat16Li64EEEvNS_6ParamsE"
    fwd = "_ZN49_GLOBAL__N__5d1c3e2a_16_rwkv6_wkv_bwd_cu_1a2b3c4d11wkv_bwd_fwdIfLi64EEEvNS_6ParamsE"
    assert chip_smoke.spilling_entries(_log(_entry(rev), _entry(fwd)), "wkv_bwd") == (2, [])
    seen, spills = chip_smoke.spilling_entries(_log(_entry(rev, 8, 8), _entry(fwd)), "wkv_bwd")
    assert seen == 2 and len(spills) == 1 and spills[0].startswith(rev)


def test_forward_of_a_gradient_takes_the_recurrent_route():
    """A train step's WKV forward (route(..., grad=True)) is recurrent in
    f32 at every length and in bf16 at T = 1, and chunk_exact in bf16 at
    head dim 64 for T >= 2; without a gradient bf16 at head dim 64 and T >=
    2 stays on the chunk route, as the serve paths count it."""
    route = chip_smoke.wkv_kernel.route
    for T in (1, 2, 200, 4096):
        assert route(torch.float32, 64, T, grad=True) == "recurrent"
        assert route(torch.bfloat16, 64, T, grad=True) == ("chunk_exact" if T >= 2
                                                           else "recurrent")
    assert route(torch.bfloat16, 64, 4096) == "chunk"
    cfg = chip_smoke.dataclasses.replace(chip_smoke.get_config("rwkv6-7b"), n_layers=2)
    assert chip_smoke.wkv_routes(cfg, torch.bfloat16, 200, 5, 0, grad=True) == {
        "chunk": 0, "chunk_exact": 5, "recurrent": 0}
    assert chip_smoke.wkv_routes(cfg, torch.float32, 200, 5, 0, grad=True) == {
        "chunk": 0, "chunk_exact": 0, "recurrent": 5}
    assert chip_smoke.wkv_routes(cfg, torch.bfloat16, 200, 5, 0) == {
        "chunk": 5, "chunk_exact": 0, "recurrent": 0}


def test_minicpm3_shapes_join_the_kernel_and_backward_cases():
    """minicpm3-4b's prefill and train shapes at (96, 64), 48 heads over 48,
    forward and backward, on the tensor cores in bf16 and the SIMT route in
    f32; the train shape with dout 0 on its 8 padded heads; each timed on
    its path."""
    for case in (chip_smoke.MINICPM3_PREFILL, chip_smoke.MINICPM3_TRAIN):
        assert case[3:7] == (48, 48, 96, 64) and case[7] and case[8] is None
        assert case in chip_smoke.KERNEL_CASES and case in chip_smoke.BWD_CASES
        for dtype, route in ((torch.float32, "simt"), (torch.bfloat16, "wgmma")):
            assert chip_smoke.fa_kernel.route(dtype, 96, 64) == route
            assert chip_smoke.fa_kernel.route(dtype, 96, 64, backward=True) == route
    assert chip_smoke.MINICPM3_PREFILL[:3] == (8, 1024, 1024)
    assert chip_smoke.MINICPM3_TRAIN[:3] == (2, 4096, 4096)
    assert chip_smoke.BWD_REAL_HEADS[chip_smoke.MINICPM3_TRAIN] == 40
    assert (2, 32, 32, 4, 4, 96, 64, True, None, 0, None) in chip_smoke.BWD_CASES
    assert chip_smoke.FLASH_PATHS["minicpm3-4b"] == chip_smoke.MINICPM3_PREFILL
    assert chip_smoke.BWD_PATHS["minicpm3-4b"][0] == chip_smoke.MINICPM3_TRAIN
    assert len(set(chip_smoke.BWD_CASES)) == len(chip_smoke.BWD_CASES)


def test_backward_bound_at_minicpm3_train_shape():
    """48 heads over 2 x 4096 causal queries: 805,502,976 pairs, three
    products of 2 x 96 and two of 2 x 64 FLOP a pair, 6.70e11 FLOP, 0.678 ms
    at 989 TFLOP/s.  The forward at the prefill shape is bound by its bytes:
    251 MB, 0.075 ms at 3.35 TB/s, beside 6.45e10 FLOP, 0.065 ms."""
    case = chip_smoke.MINICPM3_TRAIN
    bound_ms, bound_by, flops, nbytes = chip_smoke.bwd_bound(case, torch.bfloat16)
    pairs = 2 * 48 * 4096 * 4097 // 2
    assert chip_smoke.visible_pairs(case) == pairs == 805_502_976
    assert flops == 2 * pairs * (3 * 96 + 2 * 64)
    assert nbytes == 2 * (2 * 2 * 4096 * 48 * 160 + 2 * 2 * 4096 * 48 * 160) + 4 * 2 * 48 * 4096
    assert bound_by == "operations" and abs(bound_ms - 0.6776) < 1e-4
    fwd_ms, fwd_by, fwd_flops, _ = chip_smoke.attention_bound(chip_smoke.MINICPM3_PREFILL,
                                                              torch.bfloat16)
    assert fwd_flops == 2 * (8 * 48 * 1024 * 1025 // 2) * 160 and fwd_by == "bytes"
    assert abs(fwd_ms - 2 * 8 * 1024 * 48 * (96 + 96 + 64 + 64) / 3.35e9) < 1e-9


def test_spill_check_finds_the_mla_backward_kernels():
    """The SIMT backward's kernels at (96, 64), in either dtype, and none of
    the other head dims' (the build compiles them in f32 only now)."""
    dkdv = ("_ZN55_GLOBAL__N__77aa_13attn_bwd_dkdvI13__nv_bfloat16Li96ELi64ELi32ELi64EEEv"
            "NS_6ParamsE")
    dq = "_ZN55_GLOBAL__N__77aa_11attn_bwd_dqIfLi96ELi64ELi64ELi64EEEvNS_6ParamsE"
    text = _log(_entry(dkdv), _entry(dq), _entry(SIMT_BWD, 8, 8))
    assert chip_smoke.spilling_entries(text, chip_smoke.MLA_BWD_SYMBOLS) == (2, [])
    seen, spills = chip_smoke.spilling_entries(_log(_entry(dkdv), _entry(dq, 4, 4)),
                                               chip_smoke.MLA_BWD_SYMBOLS)
    assert seen == 2 and len(spills) == 1 and spills[0].startswith(dq)


def test_serve_launches_of_minicpm3():
    """62 flash launches in prefill, each on the tensor cores at (96, 64), no
    lse; the others' routes unchanged; its full-depth serve held against
    the plain path, in f32 at the f32 slices' tolerance and in bf16 within
    1.25 x the plain versions' own spread (at 62 layers that spread exceeds
    a bf16 slice's 2e-2)."""
    assert chip_smoke.SERVE_LAUNCHES["minicpm3-4b"] == {**dict.fromkeys(chip_smoke.KERNELS, 0),
                                                        "flash_attention_fwd": 62}
    assert chip_smoke.SERVE_FLASH_ROUTES["minicpm3-4b"] == {"wgmma": 62, "simt": 0}
    assert chip_smoke.SERVE_FLASH_ROUTES["qwen3-1.7b"] == {"wgmma": 28, "simt": 0}
    assert chip_smoke.SERVE_PROMPT["minicpm3-4b"] == 1024
    assert chip_smoke.SERVE_AGAINST_PLAIN == "minicpm3-4b"
    assert chip_smoke.SERVE_SPREAD_FACTOR == 1.25
    assert chip_smoke.SLICE_DTYPES[0] == (torch.float32, 1e-4)
    assert chip_smoke.attn_head_dims(chip_smoke.get_config("minicpm3-4b")) == (96, 64)
    assert chip_smoke.attn_head_dims(chip_smoke.get_config("yi-9b")) == (128, 128)


def _named(*names):
    return [getattr(chip_smoke, n) if isinstance(n, str) else n for n in names]


# KERNEL_CASES and BWD_CASES as they stood before hubert-xlarge's cases
# joined them: each case's inputs are drawn from its index, so each keeps it.
EARLIER_KERNEL_CASES = _named(
    (2, 64, 64, 4, 2, 16, 16, True, None, 0, None),
    (1, 128, 128, 8, 8, 32, 32, True, None, 0, None),
    (1, 128, 128, 4, 1, 32, 32, True, 48, 0, None), (2, 37, 93, 6, 3, 16, 16, True, None, 56, None),
    (1, 50, 50, 4, 4, 16, 16, False, None, 0, None), (1, 96, 96, 2, 2, 64, 64, True, 32, 0, None),
    (2, 32, 32, 4, 4, 96, 64, True, None, 0, None),
    (2, 70, 200, 8, 2, 128, 128, False, None, 0, 150),
    (1, 100, 100, 4, 2, 256, 256, True, None, 0, None),
    (2, 50, 50, 16, 16, 80, 80, False, None, 0, None),
    (2, 37, 93, 8, 2, 128, 128, True, None, 56, None),
    (1, 300, 300, 4, 1, 256, 256, True, 100, 0, None),
    (1, 64, 64, 4, 2, 128, 128, False, None, 0, 0),
    (2, 250, 333, 8, 2, 128, 128, True, 150, 83, 300),
    "QWEN3_TRAIN", "RECURRENTGEMMA_PREFILL_10H", "RECURRENTGEMMA_PREFILL",
    "RECURRENTGEMMA_TRAIN_10H", "YI_PREFILL", "MINITRON_PREFILL", "QWEN2_MOE_PREFILL", "YI_TRAIN",
    "MINITRON_TRAIN", "MINICPM3_PREFILL", "MINICPM3_TRAIN", "QWEN2_MOE_TRAIN")
EARLIER_BWD_CASES = [c for c in EARLIER_KERNEL_CASES[:14] if c[5] != 80] + _named(
    "QWEN3_TRAIN", "YI_PREFILL", "MINITRON_PREFILL", "QWEN2_MOE_PREFILL", "YI_TRAIN",
    "MINITRON_TRAIN", "MINICPM3_PREFILL", "MINICPM3_TRAIN", "RECURRENTGEMMA_EDGES",
    (2, 250, 333, 8, 2, 256, 256, True, 150, 83, 300),
    (1, 64, 64, 4, 2, 256, 256, False, None, 0, 0),
    "RECURRENTGEMMA_TRAIN_10H", "RECURRENTGEMMA_TRAIN", "QWEN2_MOE_TRAIN")


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "minitron-4b", "yi-9b", "qwen2-moe-a2.7b",
                                  "qwen3-moe-30b-a3b", "minicpm3-4b", "hubert-xlarge",
                                  "pixtral-12b"])
def test_train_path_flash_shapes_are_kernel_and_backward_cases(arch):
    """Each train path whose layers all attend globally gives the flash
    forward (with the lse) and the backward one shape, its padded heads
    over its kv heads (MLA: one a query head) at its train batch and
    sequence, causal but for hubert-xlarge: a case of KERNEL_CASES and of
    BWD_CASES, so both kernels are held against their plain versions at it
    in f32 and bf16.  qwen3-moe's is yi-9b's, pixtral-12b's minitron-4b's.
    Every case the lists held before a new shape joined them keeps its
    index, and with it the inputs drawn from it."""
    cfg = chip_smoke.get_config(arch)
    batch, seq = chip_smoke.TRAIN_SHAPES[arch]
    kv = cfg.padded_heads if cfg.attn_kind == "mla" else cfg.n_kv_heads
    case = (batch, seq, seq, cfg.padded_heads, kv, *chip_smoke.attn_head_dims(cfg), cfg.causal,
            None, 0, None)
    assert case in chip_smoke.KERNEL_CASES and case in chip_smoke.BWD_CASES
    assert len(EARLIER_KERNEL_CASES) == 26 and len(EARLIER_BWD_CASES) == 27
    assert chip_smoke.KERNEL_CASES[:26] == EARLIER_KERNEL_CASES
    assert chip_smoke.BWD_CASES[:27] == EARLIER_BWD_CASES


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b", "minicpm3-4b"])
def test_train_launches_of_the_new_models(arch):
    """At the cut depth, 3 L - L / k flash forward launches (k the remat
    group), each writing the lse, and L backward, on the tensor cores: the
    MoE models' at 128, minicpm3-4b's at (96, 64); in f32 all SIMT.  Their
    train slices: 2 layers, 2 x 64 tokens, flash swapped for
    chunked_attention on the plain path."""
    cfg = chip_smoke.dataclasses.replace(chip_smoke.get_config(arch),
                                         **chip_smoke.TRAIN_CUTS[arch])
    assert chip_smoke.TRAIN_SHAPES[arch] == (2, 4096)
    n = cfg.n_layers
    k = next(g for g in (8, 4, 2, 1) if n % g == 0)
    want = chip_smoke.want_train_launches(cfg, torch.bfloat16, 4096)
    assert {name: want[name] for name in chip_smoke.KERNELS} == chip_smoke.train_launches(n)
    assert want["flash_attention_fwd"] == 3 * n - n // k
    assert want["flash_attention_fwd by route"] == {"wgmma": 3 * n - n // k, "simt": 0}
    assert want["flash_attention_bwd by route"] == {"wgmma": n, "simt": 0}
    assert want["flash_attention_fwd with lse"] == 3 * n - n // k
    f32 = chip_smoke.want_train_launches(cfg, torch.float32, 4096)
    assert f32["flash_attention_bwd by route"] == {"wgmma": 0, "simt": n}
    arch_, cut, batch, seq, patches = next(s for s in chip_smoke.TRAIN_SLICES if s[0] == arch)
    assert (cut, batch, seq) == ({"n_layers": 2}, 2, 64)
    assert patches == [(chip_smoke.attention, "flash_attention",
                        chip_smoke.fa_ops.chunked_attention)]
    assert arch in [s[0] for s in chip_smoke.SLICES]
    dtypes = [d for d, _ in chip_smoke.TRAIN_SLICE_DTYPES.get(arch, chip_smoke.SLICE_DTYPES)]
    # minicpm3-4b's f32 slice met C4 on its zero-initialised ln2: bf16 only
    assert dtypes == ([torch.bfloat16] if arch == "minicpm3-4b"
                      else [torch.float32, torch.bfloat16])


def test_fused_sdpa_names_the_first_backend_that_runs(monkeypatch):
    """The first fused backend that takes the call, in FUSED_SDPA's order,
    with each refusal before it; none where every one refuses; a case at
    Dk == Dv keeps the default choice."""
    seen = []

    def fake(allowed):
        def run():
            name = seen[-1]
            if name not in allowed:
                raise RuntimeError(f"No available kernel.\n{name} refused")
            return name
        return run

    import torch.nn.attention as tna
    monkeypatch.setattr(tna, "sdpa_kernel", lambda backends: _Record(seen, backends[0].name))
    call, name = chip_smoke.fused_sdpa(fake({"EFFICIENT_ATTENTION"}))
    assert name == "EFFICIENT_ATTENTION" and call() == "EFFICIENT_ATTENTION"
    call, refused = chip_smoke.fused_sdpa(fake(set()))
    assert call is None and set(refused) == set(chip_smoke.FUSED_SDPA)
    assert refused["FLASH_ATTENTION"] == "No available kernel. FLASH_ATTENTION refused"
    fn = object()
    assert chip_smoke.library_attention(fn, chip_smoke.QWEN3_PREFILL) == (fn, None)


class _Record:
    """A stand-in for sdpa_kernel([backend]) that notes the backend."""

    def __init__(self, seen, name):
        self.seen, self.name = seen, name

    def __enter__(self):
        self.seen.append(self.name)

    def __exit__(self, *exc):
        return False


def test_twice_equal_names_the_leaves_that_differ(capsys):
    grads = [torch.zeros(2), torch.ones(2)]
    run = (grads, None, None, {"names": ["a", "b"], "master": {"a": torch.zeros(2),
                                                                "b": torch.ones(2)}})
    chip_smoke.twice_equal("x", run, run)
    assert "equal to the bit: True" in capsys.readouterr().out
    other = ([torch.zeros(2), torch.full((2,), 2.0)], None, None,
             {"names": ["a", "b"], "master": {"a": torch.zeros(2), "b": torch.ones(2)}})
    chip_smoke.twice_equal("x", run, other)
    assert "equal to the bit: False; leaves that differ: ['b']" in capsys.readouterr().out


def test_hubert_shapes_join_the_kernel_and_backward_cases_last():
    """hubert-xlarge's encode and train shapes at (80, 80), bidirectional,
    16 heads over 16, on the tensor cores in bf16 and the SIMT route in
    f32, forward and backward: appended after every earlier case of each
    list, before the masks at (80, 80) (AT_80_MASKS, last); the small
    (80, 80) case keeps its place in KERNEL_CASES and joins BWD_CASES after
    the two.  Each is timed on its path."""
    prefill, train, small = chip_smoke.HUBERT_PREFILL, chip_smoke.HUBERT_TRAIN, \
        chip_smoke.HUBERT_SMALL
    for case in (prefill, train, small):
        assert case[3:9] == (16, 16, 80, 80, False, None)
        for dtype, route in ((torch.float32, "simt"), (torch.bfloat16, "wgmma")):
            assert chip_smoke.fa_kernel.route(dtype, 80, 80) == route
            assert chip_smoke.fa_kernel.route(dtype, 80, 80, backward=True) == route
    assert (prefill[:3], train[:3]) == ((8, 1024, 1024), (2, 4096, 4096))
    masks = chip_smoke.AT_80_MASKS
    assert chip_smoke.KERNEL_CASES[-6:] == [chip_smoke.QWEN2_MOE_TRAIN, prefill, train, *masks]
    assert chip_smoke.KERNEL_CASES.index(small) == 9
    assert chip_smoke.BWD_CASES[-7:] == [chip_smoke.QWEN2_MOE_TRAIN, prefill, train, small,
                                         *masks]
    assert chip_smoke.BWD_CASES.count(small) == 1
    assert len(set(chip_smoke.BWD_CASES)) == len(chip_smoke.BWD_CASES)
    assert (80, 80) in chip_smoke.fa_kernel.BWD_HEAD_DIMS
    assert (80, 80) in chip_smoke.fa_kernel.WGMMA_HEAD_DIMS & \
        chip_smoke.fa_kernel.BWD_WGMMA_HEAD_DIMS
    assert chip_smoke.FLASH_PATHS["hubert-xlarge"] == prefill
    assert chip_smoke.BWD_PATHS["hubert-xlarge"][0] == train


def test_bounds_at_hubert_shapes():
    """Every query sees every key: 8 x 16 x 1024^2 pairs at the encode
    shape, 4.29e10 FLOP, 0.0434 ms at 989 TFLOP/s; the backward's five
    products over 2 x 16 x 4096^2 pairs, 4.29e11 FLOP, 0.434 ms."""
    fwd_ms, fwd_by, fwd_flops, _ = chip_smoke.attention_bound(chip_smoke.HUBERT_PREFILL,
                                                              torch.bfloat16)
    assert chip_smoke.visible_pairs(chip_smoke.HUBERT_PREFILL) == 8 * 16 * 1024 * 1024
    assert fwd_flops == 2 * 8 * 16 * 1024 * 1024 * 160 == 42_949_672_960
    assert fwd_by == "operations" and abs(fwd_ms - 0.04343) < 1e-5
    bwd_ms, bwd_by, bwd_flops, _ = chip_smoke.bwd_bound(chip_smoke.HUBERT_TRAIN, torch.bfloat16)
    assert bwd_flops == 2 * (2 * 16 * 4096 * 4096) * 5 * 80 == 429_496_729_600
    assert bwd_by == "operations" and abs(bwd_ms - 0.4343) < 1e-4


def test_frontend_models_tables():
    """Both serve 8 x 1024 (frames, patch embeddings) and train at 2 x 4096:
    hubert-xlarge at its full 48 layers, pixtral-12b at the depth its probe
    picked, which the train check reports as cut."""
    for arch in ("hubert-xlarge", "pixtral-12b"):
        assert chip_smoke.SERVE_PROMPT[arch] == 1024
        assert chip_smoke.TRAIN_SHAPES[arch] == (2, 4096)
    assert "hubert-xlarge" not in chip_smoke.TRAIN_CUTS
    assert chip_smoke.TRAIN_CUTS["pixtral-12b"] == {"n_layers": 9}
    assert chip_smoke.get_config("pixtral-12b").n_layers == 40
    assert chip_smoke.prompt_kind(chip_smoke.get_config("hubert-xlarge")) == "frame embeddings"
    assert chip_smoke.prompt_kind(chip_smoke.get_config("pixtral-12b")) == "patch embeddings"
    assert chip_smoke.prompt_kind(chip_smoke.get_config("yi-9b")) == "tokens"


def test_serve_launches_of_the_frontend_models():
    """hubert-xlarge encodes through 48 flash launches, on the tensor cores
    at (80, 80); pixtral-12b prefills through 40, on the tensor cores, and
    decodes with none; no WKV."""
    for arch, n, route in (("hubert-xlarge", 48, "wgmma"), ("pixtral-12b", 40, "wgmma")):
        assert chip_smoke.SERVE_LAUNCHES[arch] == {**dict.fromkeys(chip_smoke.KERNELS, 0),
                                                   "flash_attention_fwd": n}
        assert chip_smoke.get_config(arch).n_layers == n
        assert chip_smoke.SERVE_FLASH_ROUTES[arch] == {"wgmma": 0, "simt": 0, route: n}
        assert chip_smoke.SERVE_WKV_ROUTES[arch] == {"chunk": 0, "chunk_exact": 0,
                                                     "recurrent": 0}


@pytest.mark.parametrize("arch, layers, fwd, bwd, route", [
    ("hubert-xlarge", 48, 138, 48, "wgmma"), ("pixtral-12b", 9, 18, 9, "wgmma")])
def test_train_launches_of_the_frontend_models(arch, layers, fwd, bwd, route):
    """3 L - L / k forward launches (k the remat group: 8, or 1 at 9 layers), each writing
    the lse, and L backward, all on the route of the model's head dims in
    bf16; in f32 all SIMT.  Their slices run at 2 layers full width, 2 x 64
    embeddings, flash swapped for chunked_attention on the plain path."""
    cfg = chip_smoke.dataclasses.replace(chip_smoke.get_config(arch),
                                         **chip_smoke.TRAIN_CUTS.get(arch, {}))
    assert cfg.n_layers == layers
    want = chip_smoke.want_train_launches(cfg, torch.bfloat16, 4096)
    assert {name: want[name] for name in chip_smoke.KERNELS} == chip_smoke.train_launches(layers)
    assert (want["flash_attention_fwd"], want["flash_attention_bwd"]) == (fwd, bwd)
    assert want["flash_attention_fwd by route"] == {"wgmma": 0, "simt": 0, route: fwd}
    assert want["flash_attention_bwd by route"] == {"wgmma": 0, "simt": 0, route: bwd}
    assert want["flash_attention_fwd with lse"] == fwd
    f32 = chip_smoke.want_train_launches(cfg, torch.float32, 4096)
    assert f32["flash_attention_bwd by route"] == {"wgmma": 0, "simt": bwd}
    _, cut, batch, seq, patches = next(s for s in chip_smoke.TRAIN_SLICES if s[0] == arch)
    assert (cut, batch, seq) == ({"n_layers": 2}, 2, 64)
    assert patches == [(chip_smoke.attention, "flash_attention",
                        chip_smoke.fa_ops.chunked_attention)]
    _, cut, prompt_len, patches, fwd_launches, launches = next(
        s for s in chip_smoke.SLICES if s[0] == arch)
    assert (cut, prompt_len) == ({"n_layers": 2}, 64)
    assert fwd_launches == launches == {"flash_attention_fwd": 2}


def test_spill_check_finds_the_hubert_backward_kernels():
    """The SIMT backward's kernels at (80, 80), f32 only now (bf16 runs on
    the tensor cores), and none of the other head dims' nor the
    tensor-core kernels at (80, 80), whose names the wgmma check reads."""
    names = ["_ZN55_GLOBAL__N__77aa_13attn_bwd_dkdvIfLi80ELi80ELi32ELi64EEEvNS_6ParamsE",
             "_ZN55_GLOBAL__N__77aa_11attn_bwd_dqIfLi80ELi80ELi64ELi64EEEvNS_6ParamsE"]
    wgmma = [f"_ZN60_GLOBAL__N__e9e9_{n}ILi80ELi80EEEvNS_4ArgsE14CUtensorMap_stS2_S2_S2_"
             for n in ("19attn_bwd_dkdv_wgmma", "17attn_bwd_dq_wgmma")]
    mla = "_ZN55_GLOBAL__N__77aa_11attn_bwd_dqIfLi96ELi64ELi64ELi64EEEvNS_6ParamsE"
    text = _log(*(_entry(n) for n in names + wgmma), _entry(mla, 8, 8), _entry(SIMT_BWD, 8, 8))
    assert chip_smoke.spilling_entries(text, chip_smoke.HUBERT_BWD_SYMBOLS) == (2, [])
    assert chip_smoke.wgmma_ptxas_faults(text) == (2, [])
    seen, spills = chip_smoke.spilling_entries(_log(_entry(names[0]), _entry(names[1], 4, 4)),
                                               chip_smoke.HUBERT_BWD_SYMBOLS)
    assert seen == 2 and len(spills) == 1 and spills[0].startswith(names[1])


@pytest.mark.parametrize("case, causal", [("HUBERT_PREFILL", False), ("QWEN3_PREFILL", True)])
def test_sdpa_call_follows_the_case_causal_flag(case, causal, monkeypatch):
    """The library yardstick attends as the case does: hubert-xlarge's
    bidirectionally, the causal paths causally."""
    seen = {}
    monkeypatch.setattr(chip_smoke.F, "scaled_dot_product_attention",
                        lambda *a, **kw: seen.update(kw))
    q = torch.zeros(1, 4, 2, 8)
    chip_smoke.sdpa_call(q, q, q, getattr(chip_smoke, case))()
    assert seen == {"is_causal": causal, "enable_gqa": True}


def test_library_attention_names_the_backend_at_80(monkeypatch):
    """At (80, 80) the yardstick is the first fused backend that runs,
    named, as at (96, 64); at 128 and 256 SDPA's default choice."""
    seen = []
    import torch.nn.attention as tna
    monkeypatch.setattr(tna, "sdpa_kernel", lambda backends: _Record(seen, backends[0].name))
    call, name = chip_smoke.library_attention(lambda: "ran", chip_smoke.HUBERT_TRAIN)
    assert name == "FLASH_ATTENTION" and call() == "ran"
    fn = object()
    for case in (chip_smoke.QWEN3_PREFILL, chip_smoke.RECURRENTGEMMA_TRAIN):
        assert chip_smoke.library_attention(fn, case) == (fn, None)


def test_masks_at_80_join_the_kernel_and_backward_cases_last():
    """bf16 at (80, 80) takes the tensor cores for every call, so the masks
    hubert never sets are held there, forward and backward, in f32 (SIMT)
    and bf16 (wgmma): ragged with GQA, a window and q_offset; kv_len < Sk;
    kv_len 0.  They come last in both lists, so every earlier case keeps
    its index and the inputs drawn from it."""
    masks = [(2, 77, 130, 8, 2, 80, 80, True, 33, 20, None),
             (2, 70, 200, 8, 2, 80, 80, False, None, 0, 150),
             (1, 64, 64, 4, 2, 80, 80, False, None, 0, 0)]
    assert chip_smoke.AT_80_MASKS == masks
    hubert = [chip_smoke.HUBERT_PREFILL, chip_smoke.HUBERT_TRAIN]
    assert chip_smoke.KERNEL_CASES == EARLIER_KERNEL_CASES + hubert + masks
    assert chip_smoke.BWD_CASES == EARLIER_BWD_CASES + hubert + [chip_smoke.HUBERT_SMALL] + masks
    for case in masks:
        assert case not in chip_smoke.BWD_REAL_HEADS
        for dtype, route in ((torch.float32, "simt"), (torch.bfloat16, "wgmma")):
            assert chip_smoke.fa_kernel.route(dtype, case[5], case[6]) == route
            assert chip_smoke.fa_kernel.route(dtype, case[5], case[6], backward=True) == route
    assert chip_smoke.visible_pairs(masks[2]) == 0
