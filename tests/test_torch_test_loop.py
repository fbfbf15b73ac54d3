"""``multi_device_test`` in two processes against one process, on the CPU.

Two gloo processes, started as ``torchrun`` starts them
(``_torch_port_common.spawn_ranks``), each build the tiny segmentor of
``tests/_torch_port_common.py`` (``SEG_MODEL``: the finetune config's
structure at widths 8/16) from one seed, in eval mode, and run
``test_loop.multi_device_test`` over one dataset of 5 samples: W = 2 does
not divide it, one sample is a flip-view pair (the image and its
horizontal flip) and one image has another size than the rest, so the
gathered maps differ in shape.  Each rank:

* returns the list that one process's ``dataset_test`` returns on the same
  model and dataset, bit for bit (the reference is run here at the ranks'
  one thread with oneDNN off);
* read only its own samples, ``i % W == rank``, at most ⌈5 / 2⌉ of them,
  and called the model once per view of those samples.

Without a process group ``multi_device_test`` is the one-process loop.
"""

import json
import math

import numpy as np
import torch

from _torch_port_common import SEG_MODEL, spawn_ranks

WORLD = 2
HW = 32


def _dataset():
    """5 samples: 32x32 images, one 24x40, and one flip-view pair."""
    r = np.random.RandomState(0)
    images = [r.rand(HW, HW, 3).astype(np.float32) for _ in range(4)]
    images.insert(3, r.rand(24, 40, 3).astype(np.float32))
    data = [{"img": img, "img_metas": {"flip": False}} for img in images]
    data[1] = [data[1], {"img": images[1][:, ::-1].copy(), "img_metas": {"flip": True}}]
    return data


def _views(sample):
    return len(sample) if isinstance(sample, list) else 1


class _Recording:
    """The dataset, recording which samples were read."""

    def __init__(self, data):
        self.data, self.read = data, []

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        self.read.append(i)
        return self.data[i]


def _segmentor():
    from cp2_tpu_torch.models import build_segmentor
    from cp2_tpu_torch.models.layers import init_flax_like_

    model = build_segmentor(dict(SEG_MODEL))
    init_flax_like_(model, torch.Generator().manual_seed(0))
    return model.eval()


def _counted(model):
    calls = []
    model.register_forward_hook(lambda *_: calls.append(1))
    return calls


def _rank(workdir):
    """One rank: the sharded test loop; what it returned and read, saved."""
    from pathlib import Path

    from cp2_tpu_torch import parallel
    from cp2_tpu_torch.train import test_loop

    assert parallel.initialize(backend="gloo")
    model = _segmentor()
    calls = _counted(model)
    data = _Recording(_dataset())
    maps = test_loop.multi_device_test(model, data)
    rank = parallel.rank()
    parallel.shutdown()
    np.savez(Path(workdir) / f"maps{rank}.npz", *maps)
    (Path(workdir) / f"read{rank}.json").write_text(
        json.dumps({"read": data.read, "calls": len(calls)}))


def test_two_ranks_return_the_one_process_maps_each_running_its_share(tmp_path):
    from cp2_tpu_torch.train import test_loop

    spawn_ranks(__file__, "_rank", tmp_path, world=WORLD, timeout=300)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.backends.mkldnn.flags(enabled=False):
            want = test_loop.dataset_test(_segmentor(), _dataset())
    finally:
        torch.set_num_threads(threads)
    data = _dataset()
    assert len({m.shape for m in want}) == 2
    for rank in range(WORLD):
        with np.load(tmp_path / f"maps{rank}.npz") as f:
            got = [f[f"arr_{i}"] for i in range(len(f.files))]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == np.int64 and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        seen = json.loads((tmp_path / f"read{rank}.json").read_text())
        own = [i for i in range(len(data)) if i % WORLD == rank]
        assert seen["read"] == own
        assert len(seen["read"]) <= math.ceil(len(data) / WORLD)
        assert seen["calls"] == sum(_views(data[i]) for i in own)


def test_without_a_process_group_it_is_the_one_process_loop():
    from cp2_tpu_torch.train import test_loop

    model = _segmentor()
    with torch.backends.mkldnn.flags(enabled=False):
        want = test_loop.dataset_test(model, _dataset())
        calls = _counted(model)
        data = _Recording(_dataset())
        got = test_loop.multi_device_test(model, data)
    assert data.read == list(range(len(data)))
    assert len(calls) == sum(_views(s) for s in data.data)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
