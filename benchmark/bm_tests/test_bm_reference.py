"""The plain reference against the program, on the CPU at a tiny size:
the augmentations draw the same numbers and give the same images, the
networks the same outputs, and a float32 training step the same loss and
gradient."""

import copy
import math

import pytest
import torch

from bmk import checks, spec, weights
from reference import augment as ra
from reference import cp2_pretrain as rp
from reference import nets
from reference import seg_finetune as rf
from tiny import narrow


def _frames(n, hw, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, *hw, 3), generator=g, dtype=torch.uint8)


@pytest.mark.parametrize("step", [0, 1, 2])
def test_pretrain_augmentation(step):
    from cp2_tpu_torch.augment import AugmentConfig, pretrain_batch_augment
    from cp2_tpu_torch.ssl.train_step import step_generator

    cfg = dict(spec.config("cp2_r50_aspp_224")["augment"], out_hw=[40, 40])
    raw = {k: _frames(5, (56, 56), i) for i, k in enumerate(("fg", "bg0", "bg1"))}
    got = pretrain_batch_augment(step_generator(9, step, "cpu"), raw,
                                 AugmentConfig(out_hw=(40, 40)))
    want = ra.pretrain_augment(ra.step_generator(9, step, "cpu"), raw, cfg)
    for k in want:
        assert (got[k] - want[k]).abs().max() < 1e-5, k


@pytest.mark.parametrize("step", [0, 1, 2, 3])
def test_finetune_augmentation(step):
    from cp2_tpu_torch.augment import FinetuneAugmentConfig, finetune_augment_batch
    from cp2_tpu_torch.ssl.train_step import step_generator

    cfg = spec.config("deeplabv3_r50_352")["augment"]
    images = _frames(6, (40, 40), step)
    masks = (images[..., 0] > 128).to(torch.int32)
    gi, gm = finetune_augment_batch(step_generator(3, step, "cpu"), images, masks,
                                    FinetuneAugmentConfig())
    wi, wm = ra.finetune_augment(ra.step_generator(3, step, "cpu"), images, masks, cfg)
    assert (gi - wi).abs().max() < 1e-5
    assert torch.equal(gm, wm)


def _tiny(name):
    cfg = copy.deepcopy(spec.config(name))
    cfg["model"] = narrow(cfg["model"], True)
    return cfg


def test_contrast_embedding():
    from cp2_tpu_torch.ssl import SSLEncoder

    cfg = _tiny("cp2_r50_aspp_224")
    spec_ = nets.param_spec(cfg["model"], "encoder.")
    P = weights.make(spec_, 5, "cpu", cfg["init"]["branch_bn_scale"])
    model = SSLEncoder(cfg["model"], dim=128, img_hw=(64, 64))
    model.load_state_dict(P)
    img = _frames(3, (64, 64)).float() / 255.0
    got = model.train().dense(img)
    want = nets.contrast_embed(P, cfg["model"], img)
    assert (got - want).abs().max() / want.abs().max() < 1e-4


def test_segment_loss_with_dropout():
    from cp2_tpu_torch.models import build_segmentor
    from cp2_tpu_torch.ops.losses import softmax_cross_entropy
    from cp2_tpu_torch.train.segmentation_task import seg_forward

    cfg = _tiny("deeplabv3_r50_352")
    spec_ = nets.param_spec(cfg["model"])
    P = weights.make(spec_, 6, "cpu", cfg["init"]["branch_bn_scale"])
    model = build_segmentor(dict(cfg["model"], dtype=torch.float32))
    model.load_state_dict(P)
    img = _frames(3, (64, 64)).float() / 255.0
    masks = (img[..., 1] > 0.5).to(torch.int32)
    logits, _ = seg_forward(model.train(), img, (64, 64),
                            generator=torch.Generator().manual_seed(4))
    got = float(softmax_cross_entropy(logits, masks).detach())
    keep = torch.rand((3, 8, 4, 4), generator=torch.Generator().manual_seed(4)) < 0.9
    want = float(rf.loss_of(P, cfg["model"], img, masks, keep, 0.9, nets.FP32))
    assert math.isclose(got, want, rel_tol=1e-5)


def test_first_pretrain_step_in_float32():
    """The program's step in float32 and the reference's: the same loss and
    the same first gradient, leaf by leaf (median leaf)."""
    from cp2_tpu_torch.augment import AugmentConfig, pretrain_batch_augment
    from cp2_tpu_torch.ssl import SSLEncoder, SSLHyperParams
    from cp2_tpu_torch.ssl.state import PretrainState
    from cp2_tpu_torch.ssl.train_step import make_optimizer, make_pretrain_step
    from cp2_tpu_torch.types import PretrainType

    cfg = _tiny("cp2_r50_aspp_224")
    obj, aug = cfg["objective"], dict(cfg["augment"], out_hw=[64, 64])
    spec_ = nets.param_spec(cfg["model"], "encoder.")
    names = nets.trainable(spec_)
    P = weights.make(spec_, 7, "cpu", cfg["init"]["branch_bn_scale"])
    queue = weights.queue(16, 128, 7, "cpu")
    model = SSLEncoder(cfg["model"], dim=128, img_hw=(64, 64))
    model.load_state_dict(P)
    hp = SSLHyperParams.for_variant(PretrainType.CP2, queue_len=16)
    state = PretrainState(step=0, model=model.train(),
                          ema_model=copy.deepcopy(model).requires_grad_(False),
                          optimizer=make_optimizer("sgd", 1e-3)(model.parameters()),
                          queue=queue.clone(), queue_ptr=0, queue2=queue.clone(), queue2_ptr=0)
    raw = {k: _frames(8, (96, 96), i) for i, k in enumerate(("fg", "bg0", "bg1"))}
    step = make_pretrain_step(hp, 16, 16, augment_fn=lambda g, r: pretrain_batch_augment(
        g, r, AugmentConfig(out_hw=(64, 64))))
    state, metrics = step(state, raw, 11)
    got_grad = {k: state.optimizer.state[p]["momentum_buffer"] - 1e-4 * P[k]
                for k, p in model.named_parameters()}
    out = rp.run(P, queue, lambda i: raw, 11, [1e-3], cfg["model"], obj, aug,
                 {"momentum": 0.9, "weight_decay": 1e-4}, names, steps=1)
    assert math.isclose(float(metrics["loss"]), out["loss"][0], rel_tol=1e-5)
    assert max(checks.leaf_gaps(got_grad, out["grad0"]).values()) < 1e-4
