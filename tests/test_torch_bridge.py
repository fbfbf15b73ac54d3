"""The flax ⇄ torch weight bridge of the port, on a tiny ``SSLEncoder``.

flax → torch → flax is the identity on params and batch_stats, every flax
leaf lands on exactly one torch tensor and every torch tensor of the port's
module is filled (``load_state_dict(strict=True)``), and a whole
``PretrainState``, both queues included, crosses both ways unchanged.  The
other variants' trees: ``tests/test_torch_heads_necks.py``.
"""

import copy

import numpy as np
import pytest
import torch

from _torch_port_common import (
    DIM,
    jax_encoder,
    random_flax_variables,
    torch_encoder,
    unit_queue,
)
from cp2_tpu_torch.checkpoint.bridge import (
    flax_to_state_dict,
    load_flax_into,
    load_pretrain_state_from_flax,
    pretrain_state_to_flax,
    state_dict_to_flax,
)
from cp2_tpu_torch.ssl import SSLHyperParams, create_pretrain_state
from cp2_tpu_torch.ssl.train_step import make_optimizer
from cp2_tpu_torch.types import PretrainType


@pytest.fixture(scope="module")
def variables():
    return random_flax_variables(jax_encoder(), seed=3)


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _assert_same_tree(ours, ref):
    ours, ref = dict(_leaves(ours)), dict(_leaves(ref))
    assert sorted(ours) == sorted(ref)
    for path, value in ref.items():
        assert ours[path].shape == value.shape, path
        np.testing.assert_array_equal(ours[path], value, err_msg="/".join(path))


def test_flax_torch_flax_is_identity(variables):
    params, stats = variables
    model = torch_encoder()
    load_flax_into(model, params, stats)  # strict: no key missing or left over
    back_params, back_stats = state_dict_to_flax(model.state_dict())
    _assert_same_tree(back_params, params)
    _assert_same_tree(back_stats, stats)


def test_every_leaf_maps_one_to_one(variables):
    params, stats = variables
    state_dict = flax_to_state_dict(params, stats)
    n_flax = len(list(_leaves(params))) + len(list(_leaves(stats)))
    assert len(state_dict) == n_flax
    expected = torch_encoder().state_dict()
    assert sorted(state_dict) == sorted(expected)
    for key, tensor in expected.items():
        assert state_dict[key].shape == tensor.shape, key


def test_conv_and_norm_layouts(variables):
    params, stats = variables
    state_dict = flax_to_state_dict(params, stats)
    stem = params["encoder"]["backbone"]["conv1"]
    np.testing.assert_array_equal(  # HWIO → OIHW
        state_dict["encoder.backbone.conv1.conv.weight"].numpy(),
        stem["conv"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        state_dict["encoder.backbone.conv1.norm.weight"].numpy(), stem["norm"]["scale"])
    np.testing.assert_array_equal(
        state_dict["encoder.backbone.conv1.norm.running_var"].numpy(),
        stats["encoder"]["backbone"]["conv1"]["norm"]["var"])
    head = params["encoder"]["decode_head"]["contrast_conv"]["conv2"]
    np.testing.assert_array_equal(
        state_dict["encoder.decode_head.contrast_conv.conv2.bias"].numpy(), head["bias"])


def test_unmapped_leaf_raises(variables):
    params, stats = variables
    bad = copy.deepcopy(params)
    bad["encoder"]["backbone"]["conv1"]["norm"]["mystery"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="unmapped"):
        flax_to_state_dict(bad, stats)


def test_pretrain_state_round_trip(variables):
    params, stats = variables
    ema_params, ema_stats = random_flax_variables(jax_encoder(), seed=4)
    tree = {
        "params": params,
        "batch_stats": stats,
        "ema_params": ema_params,
        "ema_batch_stats": ema_stats,
        "queue": unit_queue(5, 64),
        "queue_ptr": np.int32(6),
        "queue2": unit_queue(6, 64),
        "queue2_ptr": np.int32(10),
        "step": np.int32(3),
    }
    hp = SSLHyperParams.for_variant(PretrainType.CP2, dim=DIM, queue_len=64)
    state = create_pretrain_state(torch_encoder(), make_optimizer("sgd", 0.1), hp,
                                  device="cpu")
    load_pretrain_state_from_flax(state, tree)
    assert (state.step, state.queue_ptr, state.queue2_ptr) == (3, 6, 10)
    back = pretrain_state_to_flax(state)
    for name in ("params", "batch_stats", "ema_params", "ema_batch_stats"):
        _assert_same_tree(back[name], tree[name])
    np.testing.assert_array_equal(back["queue"], tree["queue"])
    np.testing.assert_array_equal(back["queue2"], tree["queue2"])
    assert int(back["queue_ptr"]) == 6 and int(back["step"]) == 3
    assert int(back["queue2_ptr"]) == 10
    # the snapshot is a copy, not a view of the live state
    with torch.no_grad():
        state.queue.zero_()
    np.testing.assert_array_equal(back["queue"], tree["queue"])
