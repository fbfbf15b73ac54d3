"""The readers of the program's spans (``bmk/program.py``) and what
launched each kernel (``trace.Reading.launches``) on Chrome traces built
by hand, and the benchmark's own readings of the same trace.

The main trace holds three steps: a pretrain step (its backward's launches
made from a second thread inside the autograd engine's convolution
backward, a dense-loss launch by ``cuLaunchKernelEx``), then two finetune
steps, each an ``augment.finetune`` span and a ``finetune.step`` span,
with a sync call inside ``finetune.confusion``; between and after them a
launch and a sync outside every step span, inside the benchmark's ``feed``
and ``sync`` spans.  The convolution launches sit in ``aten::`` convolution
ops, but one, which sits in the program's ``model.tap_split`` span under
an ``aten::mm``.  Times are in microseconds.
"""

import json
import time

import pytest

import tiny
from bmk import main, program, readers, spec, trace

STEPS, WINDOW_S, IMAGES = 3, 0.002, 48
COUNTS = {"flops_per_step": 1e9, "conv_bound_s": 1e-5, "dense_loss_bound_s": 2e-6}
PEAK = {"bf16": 1e15}
READERS = (program.dispatch_ms, program.kernels_per_step, program.host_syncs_per_step)
SPAN_METRICS = ("dispatch_ms.pretrain", "dispatch_ms.finetune", "dispatch_ms.finetune_files",
                "kernels_per_step.pretrain", "kernels_per_step.finetune",
                "host_syncs_per_step.pretrain", "host_syncs_per_step.finetune")


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


def _op(name, ts, end, tid=1):
    return {"ph": "X", "cat": "cpu_op", "name": name, "pid": 1, "tid": tid, "ts": ts,
            "dur": end - ts, "args": {}}


BACKWARD = ("autograd::engine::evaluate_function: ConvolutionBackward0",
            "ConvolutionBackward0", "aten::convolution_backward")


def _events(program_spans=True):
    bench = [_span("step", 100, 400), _span("augment", 110, 150),
             _span("step", 500, 800), _span("augment", 500, 560), _span("feed", 810, 840),
             _span("step", 900, 1100), _span("augment", 900, 950), _span("sync", 1150, 1200)]
    ours = [
        # step A: pretrain
        _span("pretrain.step", 100, 400), _span("augment.pretrain", 110, 150),
        _span("pretrain.objective", 160, 250), _span("pretrain.backward", 250, 350),
        _span("pretrain.optimizer", 350, 390),
        _span("Optimizer.step#SGD.step", 352, 388),  # PyTorch's, not a step of the program
        # step B: finetune, its augmentation first
        _span("augment.finetune", 505, 555), _span("finetune.step", 580, 800),
        _span("finetune.forward", 590, 690), _span("finetune.confusion", 700, 790),
        # step C
        _span("augment.finetune", 900, 950), _span("finetune.step", 960, 1100),
        _span("finetune.forward", 965, 1030), _span("finetune.confusion", 1040, 1090),
    ]
    ops = [
        _op("aten::conv2d", 165, 178), _op("aten::convolution", 166, 177),
        _op("aten::_convolution", 167, 176), _op("aten::cudnn_convolution", 168, 176),
        _op(BACKWARD[0], 295, 330, tid=2), _op(BACKWARD[1], 296, 329, tid=2),
        _op(BACKWARD[2], 298, 328, tid=2),
        _op("aten::convolution", 598, 604),
        _op("aten::mm", 999, 1003),  # the tap split's GEMM, in no convolution op
    ]
    split = [_span("model.tap_split", 998, 1004)] if program_spans else []
    host = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "pid": 1, "tid": 1, "ts": 90,
         "dur": 5},
        _api("cudaLaunchKernel", 120, 125, 1),
        _api("cudaLaunchKernel", 170, 175, 2),
        _api("cuLaunchKernelEx", 180, 182, 12, cat="cuda_driver"),
        _api("cudaLaunchKernel", 300, 305, 3, tid=2),  # the autograd engine's thread
        _api("cudaMemsetAsync", 320, 321, 13, tid=2),
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
        _device("Memset (Device)", 380, 381, 13, cat="gpu_memset"),
        _device("void at::native::vectorized_elementwise_kernel<4>", 515, 540, 5),
        _device("implicit_convolve_sgemm", 605, 690, 6),
        _device("kernelHistogram1D", 708, 712, 7),
        _device("void at::native::vectorized_elementwise_kernel<4>", 825, 830, 8),
        _device("void at::native::vectorized_elementwise_kernel<4>", 915, 940, 9),
        _device("implicit_convolve_sgemm", 1003, 1035, 10),
        _device("Memcpy DtoH (Device -> Pinned)", 1159, 1165, 11, cat="gpu_memcpy"),
    ]
    return bench + (ours if program_spans else []) + split + ops + host + device


def _reading(tmp_path, events=None, counts=COUNTS):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": _events() if events is None else events}))
    return trace.Reading(str(path), STEPS, WINDOW_S, counts, PEAK, IMAGES)


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
    s_device = r.device_s(spans=(program.AUGMENT_SPANS,))
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


@pytest.mark.parametrize("keep", [
    lambda e: e.get("cat") != "user_annotation" or e["name"] in trace.SPANS,
    lambda e: not e["name"].endswith(".step")],
    ids=["program without spans", "program without step spans"])
def test_reads_nothing(tmp_path, capsys, keep):
    r = _reading(tmp_path, [e for e in _events() if keep(e)])
    for fn in READERS:
        assert fn(r) is None
    assert capsys.readouterr().err == ""


# the benchmark's own readings, which the program's spans must not move:
# worked out by hand from the benchmark's spans alone
BUSY_US = 130 + 8 + 80 + 25 + 85 + 4 + 5 + 25 + 32 + 6
# launched in convolution ops: the forward, the backward's kernel and its
# memset (a second thread), the finetune's forward; and the tap split's
# GEMM.  Not the dense loss, the optimizer or the elementwise kernels.
CONV_BY_OP_US = 60 + 70 + 1 + 85 + 32


@pytest.mark.parametrize("program_spans", [True, False], ids=["with", "without"])
def test_existing_readings_unmoved(tmp_path, program_spans):
    r = _reading(tmp_path, _events(program_spans))
    assert r.busy_s() == pytest.approx(BUSY_US / 1e6)
    assert readers.loader_wait_ms(r) is None
    assert readers.images_per_s(r) == pytest.approx(IMAGES / WINDOW_S)
    assert readers.augment_ms(r) == pytest.approx((70 + 25 + 25) / 1e6 / STEPS * 1e3)
    assert readers.mfu(r) == pytest.approx(1e9 * STEPS / WINDOW_S / 1e15 * 100)
    conv_us = CONV_BY_OP_US if program_spans else CONV_BY_OP_US - 32
    assert readers.conv_roofline(r) == pytest.approx(1e-5 * STEPS / (conv_us / 1e6) * 100)
    assert readers.dense_loss_roofline(r) == pytest.approx(2e-6 * STEPS / 8e-6 * 100)
    assert readers.device_idle(r) == pytest.approx((1 - BUSY_US / 1e6 / WINDOW_S) * 100)
    ops = dict(r.device_ops())
    assert ops == pytest.approx({
        "void at::native::vectorized_elementwise_kernel<4>": (70 + 25 + 5 + 25) / 1e6,
        "implicit_convolve_sgemm": (85 + 32) / 1e6, "void dgrad_engine<bf16>": 70e-6,
        "sm90_xmma_fprop_implicit_gemm_conv": 60e-6, "multi_tensor_apply_kernel": 10e-6,
        "void cp2::fwd_kernel<float>": 8e-6, "Memcpy DtoH (Device -> Pinned)": 6e-6,
        "kernelHistogram1D": 4e-6, "Memset (Device)": 1e-6})
    gaps = r.idle_gaps()
    assert [k for k, _ in gaps] == ["step", "augment", "feed", "other", "sync"]
    assert [v for _, v in gaps] == pytest.approx(
        [e / 1e6 for e in (2 + 40 + 125 + 18 + 113 + 124, 65 + 63, 85, 40, 35)])


def test_conv_roofline_by_launching_op(tmp_path):
    """Counted by op, the convolutions take their memset and the split's
    GEMM, which carry no convolution name; by name they would not."""
    r = _reading(tmp_path)
    assert r.category_s("convolution") == pytest.approx((60 + 70 + 85 + 32) / 1e6)
    assert readers.op_device_s(r, *readers.CONV_OPS) == pytest.approx((60 + 70 + 1 + 85) / 1e6)
    assert r.device_s(spans=readers.CONV_SPANS) == pytest.approx(32e-6)
    assert readers.conv_roofline(r) == pytest.approx(
        1e-5 * STEPS / (CONV_BY_OP_US / 1e6) * 100)
    assert readers.roofline(r, "no_such_count", ops=readers.CONV_OPS) is None
    assert readers.roofline(r, "conv_bound_s", ops=("aten::no_such_op",)) is None


def test_attribution_by_correlation_across_two_threads(tmp_path):
    """The backward's launches, made on the autograd engine's thread: their
    ops from that thread, their innermost span the main thread's."""
    r = _reading(tmp_path)
    by_name = {e["name"]: l for e, l in zip(r.kernels, r.launches)}
    for name in ("void dgrad_engine<bf16>", "Memset (Device)"):
        assert by_name[name].ops == BACKWARD
        assert by_name[name].spans[-1] == "pretrain.backward"
        assert {"step", "pretrain.step"} <= set(by_name[name].spans)
    fwd = by_name["sm90_xmma_fprop_implicit_gemm_conv"]
    assert fwd.ops == ("aten::conv2d", "aten::convolution", "aten::_convolution",
                       "aten::cudnn_convolution")
    assert fwd.spans[-1] == "pretrain.objective"
    assert by_name["multi_tensor_apply_kernel"].ops == ()
    assert by_name["implicit_convolve_sgemm"].spans[-1] == "model.tap_split"


def _small(tmp_path):
    """One step: a kernel launched in three nested convolution ops inside the
    span ``model.attention`` (which no list of the harness names), a second
    in the same span and no op, a third in neither; a kernel whose launch
    the trace lacks."""
    events = [
        _span("probe.step", 0, 100), _span("model.attention", 10, 60),
        _span("model.attention", 70, 80, tid=3),
        _op("aten::convolution", 20, 40), _op("aten::_convolution", 21, 39),
        _op("aten::cudnn_convolution", 22, 38),
        _api("cudaLaunchKernel", 25, 26, 1), _api("cudaLaunchKernel", 50, 51, 2),
        _api("cudaLaunchKernel", 90, 91, 3),
        _device("k1", 30, 40, 1), _device("k2", 52, 55, 2), _device("k3", 92, 99, 3),
        _device("k4", 100, 101, 99),
    ]
    return _reading(tmp_path, events, counts={"bound_s": 1e-6})


def test_nested_ops_and_spans_count_a_kernel_once(tmp_path):
    r = _small(tmp_path)
    assert r.device_s(ops=("aten::*convolution*",)) == pytest.approx(10e-6)
    assert r.device_s(ops=("aten::*convolution*", "aten::cudnn_*")) == pytest.approx(10e-6)
    assert r.device_s(ops=("aten::*convolution*",), spans=("model.*",)) == pytest.approx(13e-6)
    assert r.device_s(spans=("probe.step", "model.attention")) == pytest.approx(20e-6)
    assert readers.roofline(r, "bound_s", ops=("aten::*convolution*",), spans=(
        "model.attention",)) == pytest.approx(1e-6 * STEPS / 13e-6 * 100)
    assert r.launches[-1] == trace.NOT_LAUNCHED


def test_a_span_no_list_names_is_read_by_name(tmp_path):
    """Host time on two threads and device time of ``model.attention``."""
    r = _small(tmp_path)
    assert readers.span_device_ms(r, "model.attention") == pytest.approx(13e-3 / STEPS)
    assert readers.span_host_ms(r, "model.attention") == pytest.approx(60e-3 / STEPS)
    assert readers.span_host_ms(r, "model.*") == readers.span_host_ms(r, "model.attention")
    assert readers.span_device_ms(r, "model.mlp") is None
    assert readers.span_host_ms(r, "model.mlp") is None
    assert program.steps_of(r).kernels == [3]


@pytest.mark.parametrize("name", ["cp2_pretrain.resident", "seg_finetune.resident",
                                  "seg_finetune.files"])
def test_a_traced_tiny_run_shows_the_program_spans(tmp_path, monkeypatch, name):
    """A whole traced run on the CPU, at a test size, with the program's
    spans: the line holds what the benchmark reads there, among them each
    span metric the cell lists (no kernels and no syncs on the CPU); the
    trace holds the window's last ``TRACED_S`` seconds."""
    taken, read = [], trace.read

    def keep(*args):
        taken.append(read(*args))
        return taken[-1]

    monkeypatch.setattr(trace, "read", keep)
    monkeypatch.setattr(main, "TRACED_S", 0.25)  # an untraced lead, then the traced part
    cell = tiny.cell(name, str(tmp_path), trace=True)
    result = main.run_cell(cell, time.perf_counter())
    listed = {m["name"] for m in cell.per_layer()}
    assert set(result["metrics"]) <= listed
    assert "device_idle" in " ".join(result["metrics"])
    mine = listed.intersection(SPAN_METRICS)
    assert mine and mine <= set(result["metrics"])
    r, = taken
    assert 0 < r.steps < result["attempted"] and r.window_s < 0.5
    for metric in mine:
        value = result["metrics"][metric]["value"]
        assert value == spec.reader(metric)(r)
        assert value > 0 if metric.startswith("dispatch_ms") else value == 0.0
    assert program.dispatch_ms(r) > 0
