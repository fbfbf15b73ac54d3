"""The port's copies of the JAX package's JAX-free modules, and its small
step helpers, against the originals: enums, hyper-parameters, the shipped
pretrain config, output strides, the cosine schedule and the optimizer."""

import os

import numpy as np
import pytest
import torch

import cp2_tpu
import cp2_tpu_torch
from cp2_tpu import types as jax_types
from cp2_tpu.config import Config as JaxConfig
from cp2_tpu.ssl import SSLHyperParams as JaxHyperParams
from cp2_tpu.ssl.model import output_stride_of as jax_output_stride_of
from cp2_tpu.ssl import train_step as jax_train_step
from cp2_tpu_torch import types
from cp2_tpu_torch.config import Config
from cp2_tpu_torch.ssl import SSLHyperParams, output_stride_of
from cp2_tpu_torch.ssl import train_step

ENUMS = ["PretrainType", "BackboneType", "MappingType", "NegativeType",
         "DatasetType", "DataSplitType", "CutPastePatchType", "MirrorVariant", "Stage"]
VARIANTS = ["CP2", "PROPOSED", "MOCO", "BYOL", "DENSECL", "PROPOSED_V2"]


@pytest.mark.parametrize("name", ENUMS)
def test_enums_match(name):
    ours, ref = getattr(types, name), getattr(jax_types, name)
    assert [(m.name, m.value) for m in ours] == [(m.name, m.value) for m in ref]


@pytest.mark.parametrize("variant", VARIANTS)
def test_hyperparams_match(variant):
    ours = SSLHyperParams.for_variant(types.PretrainType[variant])
    ref = JaxHyperParams.for_variant(jax_types.PretrainType[variant])
    for field in ref.__dataclass_fields__:
        a, b = getattr(ours, field), getattr(ref, field)
        if hasattr(b, "name"):  # enums of the two packages
            a, b = a.name, b.name
        assert a == b, field


def test_validation_rejects_like_jax():
    with pytest.raises(ValueError, match="NegativeType.NONE"):
        SSLHyperParams.for_variant(types.PretrainType.CP2,
                                   negative_type=types.NegativeType.HARD)


def test_pretrain_config_matches_and_sets_the_strides():
    def load(pkg, config_cls):
        path = os.path.join(os.path.dirname(pkg.__file__), "configs", "config_pretrain.py")
        cfg = config_cls.fromfile(path)
        return {k: v for k, v in cfg.items() if k != "_filename"}

    ours, ref = load(cp2_tpu_torch, Config), load(cp2_tpu, JaxConfig)
    assert ours == ref
    model = dict(ours["model"])
    assert output_stride_of(model) == jax_output_stride_of(model) == 16
    for fn in ("backbone_output_stride_of", "dense_output_stride_of"):
        assert (getattr(train_step, fn)(model, types.BackboneType.DEEPLABV3)
                == getattr(jax_train_step, fn)(model, jax_types.BackboneType.DEEPLABV3)
                == 16)


def test_cosine_lr_schedule_matches_jax():
    ours = train_step.cosine_lr_schedule(0.03, epochs=10, steps_per_epoch=7)
    ref = jax_train_step.cosine_lr_schedule(0.03, epochs=10, steps_per_epoch=7)
    for step in (0, 6, 7, 30, 69):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6)


def test_sgd_is_optax_decay_then_momentum():
    """optax add_decayed_weights(wd) + sgd(lr, momentum): two steps on one
    parameter, by hand, against ``make_optimizer('sgd', ...)``."""
    p = torch.nn.Parameter(torch.tensor([1.0, -2.0]))
    opt = train_step.make_optimizer("sgd", 0.1, momentum=0.9, weight_decay=1e-2)([p])
    want, trace = np.array([1.0, -2.0]), np.zeros(2)
    for g in (np.array([0.5, 0.25]), np.array([-1.0, 2.0])):
        p.grad = torch.tensor(g, dtype=torch.float32)
        opt.step()
        trace = (g + 1e-2 * want) + 0.9 * trace
        want = want - 0.1 * trace
    np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-6)
