"""The port's spans (``utils/profiling.py::span``) on the CPU.

``span`` is a ``record_function`` only while a profiler records, and one
shared no-op context otherwise.  Under ``profiling.trace`` each traced
piece of the port (a CP2, a MoCo and a symmetric PROPOSED_V2 pretrain
step, the finetune train step, the two augmentations, a
``DevicePrefetcher`` epoch) emits its spans with their exact names, in
their order, nested inside its step's span; and a step's loss and
parameters are bitwise the same with the profiler as without it.
"""

import contextlib
import json

import numpy as np
import pytest
import torch

from _torch_port_common import (
    BATCH,
    HW,
    MOCO_MODEL,
    SEG_MODEL,
    TINY_MODEL,
    pre_augmented_batch,
    torch_encoder,
    torch_variant_encoder,
)
from cp2_tpu_torch.augment import (
    AugmentConfig,
    FinetuneAugmentConfig,
    finetune_augment_batch,
    pretrain_batch_augment,
)
from cp2_tpu_torch.data.prefetch import DevicePrefetcher, HostToDevice
from cp2_tpu_torch.models import build_segmentor
from cp2_tpu_torch.ops.metrics import ConfusionState
from cp2_tpu_torch.ssl import SSLHyperParams, create_pretrain_state
from cp2_tpu_torch.ssl.train_step import (
    backbone_output_stride_of,
    dense_output_stride_of,
    make_optimizer,
    make_pretrain_step,
)
from cp2_tpu_torch.train import segmentation_task as task
from cp2_tpu_torch.types import BackboneType, PretrainType
from cp2_tpu_torch.utils import profiling

QUEUE_LEN = 64
PRETRAIN = ["pretrain.step", "pretrain.ema", "pretrain.key_forward", "pretrain.objective",
            "pretrain.backward", "pretrain.grad_reduce", "pretrain.optimizer",
            "pretrain.enqueue", "pretrain.metrics"]
FINETUNE = ["finetune.step", "finetune.forward", "finetune.backward", "finetune.grad_reduce",
            "finetune.optimizer", "finetune.confusion"]
NAMES = set(PRETRAIN + FINETUNE + ["augment.pretrain", "augment.finetune", "data.wait"])


@pytest.fixture(autouse=True)
def numerics():
    """oneDNN off (its channels-last backward corrupts the heap on this
    CPU) and two threads, as the other port step tests run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    with torch.backends.mkldnn.flags(enabled=False):
        yield
    torch.set_num_threads(threads)


def _raw_frames(seed=0, n=BATCH, hw=HW + 8):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randint(0, 256, (n, hw, hw, 3), generator=g, dtype=torch.uint8)
            for k in ("fg", "bg0", "bg1")}


def _pretrain(name):
    """``(state, step_fn, batch)`` of a tiny pretrain variant on the CPU:
    CP2 augments raw frames inside its step, the others take the
    pre-augmented batch."""
    pt = PretrainType[name]
    over = (dict(use_symmetrical_loss=True, use_predictor=True, lmbd_coordinate=0.5)
            if pt == PretrainType.PROPOSED_V2 else {})
    hp = SSLHyperParams.for_variant(pt, dim=16, queue_len=QUEUE_LEN, **over)
    if pt == PretrainType.CP2:
        cfg, encoder = TINY_MODEL, torch_encoder()
        aug = AugmentConfig(out_hw=(HW, HW), pixel_ids_stride=hp.pixel_ids_stride)
        augment_fn = lambda gen, raw: pretrain_batch_augment(gen, raw, aug)  # noqa: E731
        batch = _raw_frames()
    else:
        cfg, encoder, augment_fn = MOCO_MODEL, torch_variant_encoder(pt, MOCO_MODEL), None
        batch = {k: torch.from_numpy(v) for k, v in pre_augmented_batch().items()}
    state = create_pretrain_state(encoder, make_optimizer("sgd", 0.1), hp, device="cpu")
    step = make_pretrain_step(
        hp, dense_output_stride_of(cfg, BackboneType.DEEPLABV3),
        backbone_output_stride=backbone_output_stride_of(cfg, BackboneType.DEEPLABV3),
        metrics_level=1, epoch_scalars=True, augment_fn=augment_fn)
    return state, step, batch


def _finetune():
    torch.manual_seed(0)
    state = task.create_seg_state(build_segmentor(SEG_MODEL), task.make_adam(1e-4, 1e-4),
                                  "cpu")
    train_step, _, _ = task.make_seg_steps(2, (HW, HW))
    r = np.random.RandomState(0)
    batch = {"image": torch.from_numpy(r.rand(4, HW, HW, 3).astype(np.float32)),
             "mask": torch.from_numpy(r.randint(0, 2, (4, HW, HW)).astype(np.int64))}
    return state, train_step, batch


def _run_pretrain(name):
    state, step, batch = _pretrain(name)
    state, metrics = step(state, batch, 3)
    return metrics["loss"], state.model


def _run_finetune():
    state, train_step, batch = _finetune()
    state, _, m = train_step(state, batch, torch.Generator().manual_seed(0),
                             ConfusionState.create(2))
    return m["loss"], state.model


def _prefetch_epoch():
    items = [{"image": np.full((2, 4, 4, 3), i, np.uint8)} for i in range(3)]
    put = HostToDevice("cpu")
    with DevicePrefetcher(items, put, depth=2) as staged:
        got = [int(b.wait()["image"][0, 0, 0, 0]) for b in staged]
    assert got == [0, 1, 2]


def _spans(log_dir):
    """The program's spans in the trace: (name, start, end) by start."""
    with open(log_dir / profiling.TRACE_NAME) as f:
        events = json.load(f)["traceEvents"]
    out = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
           if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"] in NAMES]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def test_span_is_a_shared_null_context_without_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    a, b = profiling.span("pretrain.step"), profiling.span("finetune.step")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        pass


def test_span_records_under_a_profiler(tmp_path):
    with profiling.trace(str(tmp_path)):
        s = profiling.span("pretrain.step")
        assert isinstance(s, torch.profiler.record_function)
        with s:
            torch.ones(2).sum()
    assert [n for n, _, _ in _spans(tmp_path)] == ["pretrain.step"]


CP2_ORDER = ["pretrain.step", "augment.pretrain"] + PRETRAIN[1:]
# the symmetric loss updates the key encoder again before its second keys
SYMMETRIC_ORDER = (["pretrain.step", "pretrain.ema", "pretrain.key_forward", "pretrain.ema",
                    "pretrain.key_forward"] + PRETRAIN[3:])
CASES = {
    "cp2_step": (lambda: _run_pretrain("CP2"), CP2_ORDER),
    "moco_step": (lambda: _run_pretrain("MOCO"), PRETRAIN),
    "proposed_v2_symmetric_step": (lambda: _run_pretrain("PROPOSED_V2"), SYMMETRIC_ORDER),
    "finetune_step": (_run_finetune, FINETUNE),
    "pretrain_batch_augment": (
        lambda: pretrain_batch_augment(torch.Generator().manual_seed(0), _raw_frames(),
                                       AugmentConfig(out_hw=(HW, HW))),
        ["augment.pretrain"]),
    "finetune_augment_batch": (
        lambda: finetune_augment_batch(torch.Generator().manual_seed(0),
                                       _raw_frames()["fg"],
                                       torch.zeros(BATCH, HW + 8, HW + 8, dtype=torch.int64),
                                       FinetuneAugmentConfig()),
        ["augment.finetune"]),
    # three items and the end of the epoch: four waits
    "prefetch_epoch": (_prefetch_epoch, ["data.wait"] * 4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_spans_named_ordered_and_nested(case, tmp_path):
    run, expected = CASES[case]
    with profiling.trace(str(tmp_path)):
        run()
    spans = _spans(tmp_path)
    assert [n for n, _, _ in spans] == expected
    outer = spans[0]
    if outer[0] in ("pretrain.step", "finetune.step"):
        for name, start, end in spans[1:]:
            assert outer[1] <= start and end <= outer[2], (name, outer)
        # the phases follow one another: none starts before the last ended
        for (_, _, end), (name, start, _) in zip(spans[1:], spans[2:]):
            assert end <= start, name


@pytest.mark.parametrize("case", ["cp2_step", "finetune_step"])
def test_step_is_bitwise_the_same_under_the_profiler(case, tmp_path):
    run = CASES[case][0]
    loss, model = run()
    with profiling.trace(str(tmp_path)):
        traced_loss, traced_model = run()
    assert torch.equal(loss, traced_loss)
    for (name, p), (_, q) in zip(model.state_dict().items(),
                                 traced_model.state_dict().items()):
        assert torch.equal(p, q), name
