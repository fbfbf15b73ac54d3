"""The benchmark's FLOP count of a step (the reference's step on the meta
device, XLA's rules) equals the program's own count (``utils/flops.py``)
of the same step at a narrow width."""

import copy

import torch

from bmk import counts, spec
from tasks import cp2_pretrain, seg_finetune
from tiny import narrow

BATCH, HW = 2, 64


def _cfg(name):
    cfg = copy.deepcopy(spec.config(name))
    cfg["model"] = narrow(cfg["model"], True)
    return cfg


def test_pretrain_count_equals_the_programs():
    from cp2_tpu_torch.ssl import SSLEncoder, SSLHyperParams
    from cp2_tpu_torch.ssl.state import PretrainState
    from cp2_tpu_torch.ssl.train_step import make_optimizer, make_pretrain_step
    from cp2_tpu_torch.tools.bench_pretrain_variant import pretrain_batch_shapes
    from cp2_tpu_torch.types import PretrainType
    from cp2_tpu_torch.utils.flops import flop_counter

    cfg = _cfg("cp2_r50_aspp_224")
    obj = cfg["objective"]
    hp = SSLHyperParams.for_variant(PretrainType.CP2, queue_len=obj["queue_len"])
    with torch.device("meta"):
        model = SSLEncoder(cfg["model"], dim=hp.dim, dtype=torch.bfloat16, img_hw=(HW, HW))
        ema = copy.deepcopy(model).requires_grad_(False)
        queue = torch.empty(hp.queue_len, hp.dim)
    state = PretrainState(step=0, model=model.train(), ema_model=ema.train(),
                          optimizer=make_optimizer("sgd", 1e-3)(model.parameters()),
                          queue=queue, queue_ptr=0, queue2=queue.clone(), queue2_ptr=0)
    step = make_pretrain_step(hp, obj["output_stride"], obj["output_stride"])
    with flop_counter() as counter:
        step(state, pretrain_batch_shapes(BATCH, HW))
    ours = cp2_pretrain.step_counts(cfg, BATCH, (HW, HW), 2, None)["flops_per_step"]
    assert ours == counter.get_total_flops() > 0


def test_finetune_count_equals_the_programs():
    from cp2_tpu_torch.models import build_segmentor
    from cp2_tpu_torch.train.segmentation_task import SegTrainState, make_adam, make_seg_steps
    from cp2_tpu_torch.utils.flops import flop_counter

    cfg = _cfg("deeplabv3_r50_352")
    with torch.device("meta"):
        model = build_segmentor(dict(cfg["model"], dtype=torch.bfloat16)).train()
        images = torch.empty(BATCH, HW, HW, 3)
        masks = torch.empty(BATCH, HW, HW, dtype=torch.int32)
    state = SegTrainState(model=model, optimizer=make_adam(1e-4, 1e-4)(model.parameters()))
    train_step, _, _ = make_seg_steps(2, (HW, HW))

    class NoConfusion:
        def update(self, *a, **k):
            return self

    with flop_counter() as counter:
        train_step(state, {"image": images, "mask": masks},
                   torch.Generator().manual_seed(0), NoConfusion())
    ours = seg_finetune.step_counts(cfg, BATCH, (HW, HW), 2, None)["flops_per_step"]
    assert ours == counter.get_total_flops() > 0


def test_valid_taps_at_dilation_18():
    """At a 14x14 grid a dilation-18 3x3 convolution reads only its centre
    tap, which is all XLA counts."""
    full = counts.conv_flops((1, 8, 14, 14), (4, 8, 3, 3), (1, 4, 14, 14), 1, 18, 18)
    assert full == 2 * 4 * 8 * 14 * 14


def test_dense_loss_bound_is_bytes_bound_at_the_cells_shape():
    peak = counts.peaks("NVIDIA H100 80GB HBM3")
    bound = counts.dense_loss_bound_s(64, 196, 128, peak)
    assert 5e-6 < bound < 2e-5
