"""The readers of the program's spans (``bmk/program.py``) on a Chrome
trace built by hand, and the benchmark's own readings of the same trace.

The trace holds three steps: a pretrain step (its backward's launch made
from a second thread, a dense-loss launch by ``cuLaunchKernelEx``), then
two finetune steps, each an ``augment.finetune`` span and a
``finetune.step`` span, with a sync call inside ``finetune.confusion``;
between and after them a launch and a sync outside every step span,
inside the benchmark's ``feed`` and ``sync`` spans.  Times are in
microseconds.

The readers take the trace's events from a Reading that keeps them
(``_Kept`` below); the harness's own ``trace.Reading`` does not, and
there they read nothing.
"""

import json
import time

import pytest

import tiny
from bmk import main, program, readers, trace

STEPS, WINDOW_S, IMAGES = 3, 0.002, 48
COUNTS = {"flops_per_step": 1e9, "conv_bound_s": 1e-5, "dense_loss_bound_s": 2e-6}
PEAK = {"bf16": 1e15}
READERS = (program.dispatch_ms, program.kernels_per_step, program.host_syncs_per_step)


class _Kept(trace.Reading):
    """A Reading that keeps the trace's events, as the readers need."""

    def __init__(self, path, *args):
        with open(path) as f:
            self.events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        super().__init__(path, *args)


def _span(name, ts, end, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": end - ts}


def _api(name, ts, end, corr=None, tid=1, cat="cuda_runtime"):
    e = {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": ts, "dur": end - ts,
         "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def _device(name, ts, end, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": ts, "dur": end - ts,
            "args": {"correlation": corr}}


def _events(program_spans=True):
    bench = [_span("step", 100, 400), _span("augment", 110, 150),
             _span("step", 500, 800), _span("augment", 500, 560), _span("feed", 810, 840),
             _span("step", 900, 1100), _span("augment", 900, 950), _span("sync", 1150, 1200)]
    ours = [
        # step A: pretrain
        _span("pretrain.step", 100, 400), _span("augment.pretrain", 110, 150),
        _span("pretrain.objective", 160, 250), _span("pretrain.backward", 250, 350),
        _span("pretrain.optimizer", 350, 390),
        # step B: finetune, its augmentation first
        _span("augment.finetune", 505, 555), _span("finetune.step", 580, 800),
        _span("finetune.forward", 590, 690), _span("finetune.confusion", 700, 790),
        # step C
        _span("augment.finetune", 900, 950), _span("finetune.step", 960, 1100),
        _span("finetune.forward", 965, 1030), _span("finetune.confusion", 1040, 1090),
    ]
    host = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "pid": 1, "tid": 1, "ts": 90,
         "dur": 5},
        _api("cudaLaunchKernel", 120, 125, 1),
        _api("cudaLaunchKernel", 170, 175, 2),
        _api("cuLaunchKernelEx", 180, 182, 12, cat="cuda_driver"),
        _api("cudaLaunchKernel", 300, 305, 3, tid=2),  # the autograd engine's thread
        _api("cudaLaunchKernel", 360, 362, 4),
        _api("cudaLaunchKernel", 510, 512, 5),
        _api("cudaLaunchKernel", 600, 603, 6),
        _api("cudaLaunchKernel", 705, 707, 7),
        _api("cudaStreamSynchronize", 720, 760),
        _api("cudaLaunchKernel", 820, 822, 8),  # outside every step span
        _api("cudaLaunchKernel", 910, 912, 9),
        _api("cudaLaunchKernel", 1000, 1002, 10),
        _api("cuStreamSynchronize", 1050, 1060, cat="cuda_driver"),
        _api("cudaMemcpyAsync", 1155, 1158, 11),
        _api("cudaStreamSynchronize", 1160, 1190),  # outside every step span
    ]
    device = [
        _device("void at::native::vectorized_elementwise_kernel<4>", 130, 200, 1),
        _device("sm90_xmma_fprop_implicit_gemm_conv", 200, 260, 2),
        _device("void cp2::fwd_kernel<float>", 262, 270, 12),
        _device("void dgrad_engine<bf16>", 310, 380, 3),
        _device("multi_tensor_apply_kernel", 380, 390, 4),
        _device("void at::native::vectorized_elementwise_kernel<4>", 515, 540, 5),
        _device("implicit_convolve_sgemm", 605, 690, 6),
        _device("kernelHistogram1D", 708, 712, 7),
        _device("void at::native::vectorized_elementwise_kernel<4>", 825, 830, 8),
        _device("void at::native::vectorized_elementwise_kernel<4>", 915, 940, 9),
        _device("implicit_convolve_sgemm", 1003, 1035, 10),
        _device("Memcpy DtoH (Device -> Pinned)", 1159, 1165, 11, cat="gpu_memcpy"),
    ]
    return bench + (ours if program_spans else []) + host + device


def _reading(tmp_path, program_spans=True, kept=True):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": _events(program_spans)}))
    return (_Kept if kept else trace.Reading)(str(path), STEPS, WINDOW_S, COUNTS, PEAK, IMAGES)


# the window: pretrain.step 300 + augment.finetune 50 + finetune.step 220
# + augment.finetune 50 + finetune.step 140; the syncs inside it 40 and 10
WINDOW_US, SYNC_US = 300 + 50 + 220 + 50 + 140, 40 + 10
EXPECTED = {
    "dispatch_ms": (WINDOW_US - SYNC_US) / STEPS / 1e3,
    # by step: A launches 5 (one from the autograd thread, one by
    # cuLaunchKernelEx), B 3 (one in its augmentation), C 2; the launch at
    # 820 is outside the window
    "kernels_per_step": 3.0,
    # by step: 0, 1, 1; the sync at 1160 is outside the window
    "host_syncs_per_step": 1.0,
}


def test_steps_by_hand(tmp_path):
    s = program.steps_of(_reading(tmp_path))
    assert s.kernels == [5, 3, 2] and s.syncs == [0, 1, 1]
    assert s.window_s == pytest.approx(WINDOW_US / 1e6)
    assert s.sync_s == pytest.approx(SYNC_US / 1e6)


@pytest.mark.parametrize("fn", READERS, ids=lambda fn: fn.__name__)
def test_each_reader_by_hand(tmp_path, fn):
    assert fn(_reading(tmp_path)) == pytest.approx(EXPECTED[fn.__name__])


def test_idle_split_by_program_span(tmp_path, capsys):
    r = _reading(tmp_path)
    idle = program.steps_of(r).idle_ms_per_step(r, STEPS)
    s_device = program.steps_of(r).device_s(r, program.AUGMENT_SPANS)
    # each gap by where the host was when it began (see the module docstring)
    want_us = {"pretrain.backward": 2 + 40, "pretrain.optimizer": 125,
               "augment.finetune": 65 + 63, "finetune.forward": 18,
               "finetune.confusion": 113, "finetune.step": 124, "other": 40 + 85 + 35}
    assert idle.keys() == want_us.keys()
    for k, v in want_us.items():
        assert idle[k] == pytest.approx(v / 1e3 / STEPS), k
    err = capsys.readouterr().err
    assert err.count("program idle ms/step by span:") == 1  # printed once a reading
    assert ("syncs 2 (by step 0x1 1x2, 0.017 ms/step, {'cudaStreamSynchronize': 1, "
            "'cuStreamSynchronize': 1})") in err
    # augment.pretrain launches K1 (70), augment.finetune K5 and K9 (25 each)
    assert s_device == pytest.approx((70 + 25 + 25) / 1e6)


@pytest.mark.parametrize("program_spans,kept", [(False, True), (True, False)],
                         ids=["program without spans", "reading without events"])
def test_reads_nothing(tmp_path, capsys, program_spans, kept):
    r = _reading(tmp_path, program_spans, kept)
    for fn in READERS:
        assert fn(r) is None
    assert capsys.readouterr().err == ""


# the benchmark's own readings, which the program's spans must not move:
# worked out by hand from the benchmark's spans alone
BUSY_US = 130 + 8 + 80 + 25 + 85 + 4 + 5 + 25 + 32 + 6
CONV_US = 60 + 70 + 85 + 32


@pytest.mark.parametrize("program_spans", [True, False], ids=["with", "without"])
def test_existing_readings_unmoved(tmp_path, program_spans):
    r = _reading(tmp_path, program_spans, kept=False)
    assert r.busy_s() == pytest.approx(BUSY_US / 1e6)
    assert readers.loader_wait_ms(r) is None
    assert readers.images_per_s(r) == pytest.approx(IMAGES / WINDOW_S)
    assert readers.augment_ms(r) == pytest.approx((70 + 25 + 25) / 1e6 / STEPS * 1e3)
    assert readers.mfu(r) == pytest.approx(1e9 * STEPS / WINDOW_S / 1e15 * 100)
    assert readers.conv_roofline(r) == pytest.approx(1e-5 * STEPS / (CONV_US / 1e6) * 100)
    assert readers.dense_loss_roofline(r) == pytest.approx(2e-6 * STEPS / 8e-6 * 100)
    assert readers.device_idle(r) == pytest.approx((1 - BUSY_US / 1e6 / WINDOW_S) * 100)
    ops = dict(r.device_ops())
    assert ops == pytest.approx({
        "void at::native::vectorized_elementwise_kernel<4>": (70 + 25 + 5 + 25) / 1e6,
        "implicit_convolve_sgemm": (85 + 32) / 1e6, "void dgrad_engine<bf16>": 70e-6,
        "sm90_xmma_fprop_implicit_gemm_conv": 60e-6, "multi_tensor_apply_kernel": 10e-6,
        "void cp2::fwd_kernel<float>": 8e-6, "Memcpy DtoH (Device -> Pinned)": 6e-6,
        "kernelHistogram1D": 4e-6})
    gaps = r.idle_gaps()
    assert [k for k, _ in gaps] == ["step", "augment", "feed", "other", "sync"]
    assert [v for _, v in gaps] == pytest.approx(
        [e / 1e6 for e in (2 + 40 + 125 + 18 + 113 + 124, 65 + 63, 85, 40, 35)])


@pytest.mark.parametrize("name", ["cp2_pretrain.resident", "seg_finetune.resident",
                                  "seg_finetune.files"])
def test_a_traced_tiny_run_shows_the_program_spans(tmp_path, monkeypatch, name):
    """A whole traced run on the CPU, at a test size, with the program's
    spans: the line holds what the benchmark reads there, and the trace
    holds step spans the readers find (no kernels and no syncs on the CPU)."""
    taken = []

    def read(path, *args):
        taken.append(_Kept(path, *args))
        return taken[-1]

    monkeypatch.setattr(trace, "read", read)
    cell = tiny.cell(name, str(tmp_path), trace=True)
    result = main.run_cell(cell, time.perf_counter())
    assert set(result["metrics"]) <= {m["name"] for m in cell.per_layer()}
    assert "device_idle" in " ".join(result["metrics"])
    r, = taken
    assert program.dispatch_ms(r) > 0
    assert program.kernels_per_step(r) == 0.0 and program.host_syncs_per_step(r) == 0.0
