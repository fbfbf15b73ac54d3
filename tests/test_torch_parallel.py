"""The port's collectives and process layout (``cp2_tpu_torch/parallel``),
on the CPU.

The bootstrap's contract is the JAX package's
(``tests/test_collectives.py``): with no launch environment ``initialize``
is a no-op that touches nothing, and a rendezvous that nothing answers
raises rather than carrying on as one process.  The collectives run in two
processes over gloo, started as ``torchrun`` starts them; one pair of
processes computes every case (``_ranks``) and the tests read what each
rank wrote.  Every comparison is exact: the collectives add zeros, sum
integers, or sum and halve two float32 values, which the reference on
this side computes the same way.
"""

import os
import pickle
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_port_common import free_ports, spawn_ranks
from cp2_tpu_torch import parallel
from cp2_tpu_torch.parallel import Layout, initialize, take_rows

LAUNCH_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
BIG = 3 * 2**40  # int64 counts beyond float32's and int32's range


def _rank_inputs(rank):
    """What rank ``rank`` hands the collectives (the parent rebuilds it)."""
    r = np.random.RandomState(rank)
    return {
        "x": torch.from_numpy(r.randn(3, 4).astype(np.float32)),
        "grads": [torch.from_numpy(r.randn(5, 2).astype(np.float32)),
                  torch.from_numpy(r.randn(7).astype(np.float32))],
        "counts": torch.tensor([[BIG + rank, 7], [rank, 2**40]], dtype=torch.int64),
        "loss": torch.tensor(0.25 * (rank + 1)),
    }


def _ranks(workdir):
    """One rank of the pair: every collective once, its results pickled."""
    rank = int(os.environ["RANK"])
    out = {}
    # process_group joins the group the environment describes and leaves it
    with parallel.process_group("cpu") as layout:
        out["layout"] = (layout.rank, layout.world, layout.shard, str(layout.device))
        out["active_inside"] = parallel.is_active()
        out["initialize_again"] = initialize()
    out["active_after"] = parallel.is_active()

    # a second group at an address of its own: the first group's store may
    # still be closing on the launch port
    with open(os.path.join(workdir, "port")) as f:
        port = int(f.read())
    assert initialize(backend="gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                      rank=rank)
    inputs = _rank_inputs(rank)
    out["gathered"] = parallel.concat_all_gather(inputs["x"].requires_grad_())
    params = [torch.nn.Parameter(torch.zeros_like(g)) for g in inputs["grads"]]
    for p, g in zip(params, inputs["grads"]):
        p.grad = g.clone()
    parallel.pmean_gradients(params)
    out["mean_grads"] = [p.grad for p in params]
    out["psum"] = parallel.psum_metrics({"counts": inputs["counts"], "loss": inputs["loss"]})
    out["pmean"] = parallel.pmean_metrics({"loss": inputs["loss"], "n": torch.tensor(rank)})
    same = [torch.ones(3)]
    parallel.check_replicas(same)
    try:
        parallel.check_replicas([torch.full((3,), float(rank))])
        out["replicas_differ"] = None
    except RuntimeError as e:
        out["replicas_differ"] = str(e)
    # barrier: rank 1 writes a file late; rank 0 looks for it after the barrier
    marker = os.path.join(workdir, "late")
    if rank == 1:
        time.sleep(1.0)
        with open(marker, "w") as f:
            f.write("x")
    parallel.barrier()
    out["after_barrier_sees_file"] = os.path.exists(marker)
    parallel.shutdown()
    with open(os.path.join(workdir, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("parallel")
    (workdir / "port").write_text(str(free_ports(1)[0]))
    spawn_ranks(__file__, "_ranks", workdir, timeout=120)
    outs = []
    for rank in range(2):
        with open(workdir / f"out{rank}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs


def test_initialize_is_a_noop_without_a_launch_environment(monkeypatch):
    """No argument and none of torchrun's variables: False, no group, and
    ``process_group`` runs the body as one process (rank 0 of 1)."""
    for name in LAUNCH_ENV:
        monkeypatch.delenv(name, raising=False)
    assert initialize() is False
    assert not dist.is_initialized()
    with parallel.process_group("cpu") as layout:
        assert layout == Layout(0, 1, 0, torch.device("cpu"))
        assert not dist.is_initialized()


def test_initialize_raises_when_nothing_answers():
    """Rank 1 of 2 at an address nothing listens on: the rendezvous times
    out and raises; no group is left behind."""
    port = free_ports(1)[0]
    t = time.monotonic()
    with pytest.raises(Exception) as info:
        initialize(backend="gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                   rank=1, timeout=3)
    assert not dist.is_initialized()
    assert time.monotonic() - t < 60, info.value


def test_process_group_joins_and_leaves(ranks):
    for rank, out in enumerate(ranks):
        assert out["layout"] == (rank, 2, (rank, 2), "cpu")
        assert out["active_inside"] and out["initialize_again"]
        assert not out["active_after"]


def test_concat_all_gather_is_rank_order_exactly(ranks):
    want = torch.cat([_rank_inputs(r)["x"] for r in range(2)])
    for out in ranks:
        assert torch.equal(out["gathered"], want)
        assert not out["gathered"].requires_grad


def test_pmean_gradients_averages_in_place(ranks):
    want = [(a + b) / 2 for a, b in zip(_rank_inputs(0)["grads"], _rank_inputs(1)["grads"])]
    for out in ranks:
        for got, ref in zip(out["mean_grads"], want):
            assert torch.equal(got, ref)


def test_psum_metrics_sums_int64_and_float(ranks):
    counts = _rank_inputs(0)["counts"] + _rank_inputs(1)["counts"]
    for out in ranks:
        assert out["psum"]["counts"].dtype == torch.int64
        assert torch.equal(out["psum"]["counts"], counts)
        assert int(out["psum"]["counts"][0, 0]) == 2 * BIG + 1
        assert float(out["psum"]["loss"]) == 0.75


def test_pmean_metrics_is_the_mean_over_ranks_in_float32(ranks):
    for out in ranks:
        assert float(out["pmean"]["loss"]) == 0.375
        assert out["pmean"]["n"].dtype == torch.float32 and float(out["pmean"]["n"]) == 0.5


def test_barrier_waits_for_every_rank(ranks):
    assert all(out["after_barrier_sees_file"] for out in ranks)


def test_check_replicas_raises_on_every_rank_when_weights_differ(ranks):
    for out in ranks:
        assert "ranks hold different weights" in out["replicas_differ"]


def test_layout_rows_and_local_batch():
    """``local_batch`` raises the JAX CLIs' ``ValueError`` on a global batch
    the processes do not divide; ``rows`` and ``take_rows`` keep this
    rank's rows of a draw for the global batch, and leave other leaves."""
    layout = Layout(rank=1, world=2)
    assert layout.local_batch(8) == 4
    with pytest.raises(ValueError, match="not divisible by 2 processes"):
        layout.local_batch(7)
    x = torch.arange(8)
    assert torch.equal(layout.rows(x), torch.tensor([4, 5, 6, 7]))
    from cp2_tpu_torch.augment.functional import JitterParams

    params = JitterParams(*(x.float() + i for i in range(5)), order=3)
    cut = take_rows({"j": params, "none": None}, layout)
    assert cut["none"] is None and cut["j"].order == 3
    assert torch.equal(cut["j"].hue, torch.tensor([7.0, 8.0, 9.0, 10.0]))
    assert take_rows(params, Layout()) is params
