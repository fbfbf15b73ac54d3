"""The port's inference utilities and test loop against the JAX package's,
on the CPU.

The segmentor is ``tests/test_finetune_task.py``'s ``TINY_SEG`` (a dilated
ResNet-18 at width 8 under an ASPP-16 classifier) on 32x32 images, eval
mode, float32; both sides start from numpy weights through the bridge.

* ``whole_inference`` and ``slide_inference`` (overlapping windows, the
  last clamped to the border): logits at rtol 1e-5 with an absolute floor
  of 1e-5 of the largest logit (``assert_close``), the eval forward's
  tolerance in ``tests/test_torch_segmentation_task.py``.
* A slide whose window is the image equals whole inference (1e-6: the same
  computation); the window grid's visit counts equal a count by hand.
* ``dataset_test`` over a list dataset with single-view samples and
  MultiScaleFlipAug-style samples (the image and its horizontal flip, the
  flipped view's probabilities un-flipped): class maps equal to JAX's.
* ``init_segmentor`` refuses a directory without the port's ``state.pt``
  (an orbax checkpoint), and with no card raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import assert_close, fill_variables
from cp2_tpu.models import build_segmentor as jax_build_segmentor
from cp2_tpu.train import inference as jinference
from cp2_tpu.train import test_loop as jtest_loop
from cp2_tpu_torch.checkpoint.bridge import load_flax_into
from cp2_tpu_torch.train import inference, test_loop
from tests.test_finetune_task import HW, TINY_SEG

RTOL = 1e-5
CROP, STRIDE = (HW // 2 + 4, HW // 2 + 4), (HW // 4 + 1, HW // 4 + 1)


@pytest.fixture(scope="module")
def seg():
    """The JAX segmentor with numpy weights, the port's twin in eval mode."""
    model = jax_build_segmentor(TINY_SEG)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, HW, HW, 3)), train=False))
    params, stats = fill_variables(shapes, np.random.RandomState(0))
    port = inference.init_segmentor(TINY_SEG, device="cpu")
    load_flax_into(port, params, stats)
    return model, {"params": params, "batch_stats": stats}, port.eval()


def _images(n, seed=0):
    return np.random.RandomState(seed).rand(n, HW, HW, 3).astype(np.float32)


def test_whole_inference_matches_jax(seg):
    model, variables, port = seg
    x = _images(2)
    ref = jinference.whole_inference(model, variables, jnp.asarray(x))
    with torch.no_grad():
        ours = inference.whole_inference(port, torch.from_numpy(x))
    assert ours.shape == (2, HW, HW, 2) and ours.dtype == torch.float32
    assert_close(ours.numpy(), np.asarray(ref), RTOL, "whole logits")
    classes = inference.inference_segmentor(port, torch.from_numpy(x))
    np.testing.assert_array_equal(classes.numpy(), np.asarray(
        jinference.inference_segmentor(model, variables, jnp.asarray(x))))


def test_slide_inference_matches_jax(seg):
    model, variables, port = seg
    x = _images(2, seed=1)
    ref = jinference.slide_inference(model, variables, jnp.asarray(x), crop_size=CROP,
                                     stride=STRIDE, num_classes=2)
    with torch.no_grad():
        ours = inference.slide_inference(port, torch.from_numpy(x), crop_size=CROP,
                                         stride=STRIDE, num_classes=2)
    assert ours.shape == (2, HW, HW, 2)
    assert_close(ours.numpy(), np.asarray(ref), RTOL, "slide logits")


def test_slide_with_window_equal_to_image_is_whole(seg):
    _, _, port = seg
    x = torch.from_numpy(_images(1, seed=2))
    with torch.no_grad():
        whole = inference.whole_inference(port, x)
        slid = inference.slide_inference(port, x, crop_size=(HW, HW), stride=(HW, HW),
                                         num_classes=2)
    np.testing.assert_allclose(slid.numpy(), whole.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("hw,crop,stride", [((32, 32), (20, 20), (9, 9)),
                                            ((352, 352), (256, 256), (170, 170)),
                                            ((30, 44), (16, 24), (16, 7))])
def test_slide_counts_equal_a_count_by_hand(hw, crop, stride):
    counts = np.zeros(hw, np.int64)
    y0 = 0
    while True:  # mmseg's grid: step by the stride, clamp the last window
        ys = min(y0, hw[0] - crop[0])
        x0 = 0
        while True:
            xs = min(x0, hw[1] - crop[1])
            counts[ys:ys + crop[0], xs:xs + crop[1]] += 1
            if x0 + crop[1] >= hw[1]:
                break
            x0 += stride[1]
        if y0 + crop[0] >= hw[0]:
            break
        y0 += stride[0]
    ours = inference.slide_counts(hw, crop, stride)
    assert ours.shape == (1, *hw, 1)
    np.testing.assert_array_equal(ours[0, ..., 0].numpy(), counts)
    assert counts.min() >= 1


def test_dataset_test_with_flip_views_matches_jax(seg):
    model, variables, port = seg
    images = _images(3, seed=3)
    dataset = [{"img": images[0], "img_metas": {"flip": False}}]
    for img in images[1:]:
        dataset.append([{"img": img, "img_metas": {"flip": False}},
                        {"img": img[:, ::-1].copy(), "img_metas": {"flip": True}}])
    ref = jtest_loop.dataset_test(model, variables, dataset)
    ours = test_loop.single_device_test(port, dataset)
    assert len(ours) == len(ref) == 3
    for got, want in zip(ours, ref):
        assert got.shape == (HW, HW) and got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
    assert test_loop.multi_device_test(port, dataset[:1])[0].shape == (HW, HW)


def test_init_segmentor_refuses_orbax_and_needs_a_card(tmp_path, monkeypatch):
    (tmp_path / "7").mkdir()
    with pytest.raises(ValueError, match="no state.pt"):
        inference.init_segmentor(TINY_SEG, str(tmp_path / "7"), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference.init_segmentor(TINY_SEG)
