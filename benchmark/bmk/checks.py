"""The comparison that decides ``correct``.

The program's first three steps (taken in set-up, through the window's own
call and feed) against the reference's three steps from the same weights
and inputs.  The numbers a configuration's ``limits`` name are compared:

* ``loss``: the largest relative gap of a step's loss;
* ``grad``: the first step's gradient as the optimizer got it (worked out
  from the optimizer's state after one step), by the worst leaf: the gap
  between the program's and the reference's norms of the leaf, over the
  larger of the reference's norm of that leaf and of the median leaf;
* ``change``: the parameters' change over the three steps, the same way,
  leaving out the leaves whose reference gradient is under a thousandth of
  the median leaf's (nought to rounding: they move by round-off alone);
* ``ema`` (CP2): the key encoder's move over the three steps (the EMA of
  the query encoder, from the same start), the same way as ``change``,
  leaving out also the leaves whose reference move is under ``EMA_ULPS``
  float32 ulps of their values (by the norms of the move and of the
  leaf's ulps, each element's at the larger of its start and its end): a
  key moves a thousandth of the query's step, about one ulp of most
  weights, and there whether an element moves by one ulp or none is
  decided by the last bits of the gradient;
* ``loader`` (cells fed from files): the largest difference between the
  loader's decoded uint8 batches and the reference's own decoding.

* ``grad_diff``: the first gradient's worst leaf by the norm of the
  difference, where a gap of norms cannot see the fault: it is second
  order in rounding, and blind to a convolution whose taps are shifted,
  which keeps its gradient's norm.

``readings`` also gives the first step's loss gap and the median leaf's
gaps, which no limit names today; each run prints them all.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

ZERO_GRAD = 1e-3  # a leaf's gradient under this share of the median leaf's counts as nought
EMA_ULPS = 4.0  # a key leaf's move under this many float32 ulps of its values is rounding


def host_copy(t: torch.Tensor) -> torch.Tensor:
    """A copy on the host, also of a tensor already there."""
    return t.detach().to("cpu", copy=True)


def moment(optimizer, p: torch.Tensor, key: str) -> torch.Tensor:
    """The optimizer's ``key`` state of ``p`` on the host; zeros where the
    optimizer holds none (it never stepped)."""
    state = optimizer.state.get(p, {})
    return host_copy(state[key]) if key in state else torch.zeros(p.shape)


def max_diff(got: torch.Tensor, want) -> float:
    """Largest absolute difference of two integer arrays."""
    return float((got.long() - torch.from_numpy(want).long()).abs().max())


def host(named) -> Dict[str, torch.Tensor]:
    return {k: host_copy(v) for k, v in named}


def _median(values):
    v = sorted(values)
    return v[len(v) // 2] if v else 0.0


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep=None, of_difference: bool = False) -> Dict[str, float]:
    """Each leaf's gap over the larger of the reference's norm of that leaf
    and of the median leaf (among those not exactly zero): the gap of the
    norms, |‖p‖ − ‖r‖|, or with ``of_difference`` the norm of the
    difference, ‖p − r‖."""
    names = [k for k in ref if keep is None or k in keep]
    ref_norm = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in names}
    med = _median([v for v in ref_norm.values() if v > 0])
    out = {}
    for k in names:
        if of_difference:
            gap = float(torch.linalg.vector_norm(prog[k].double() - ref[k].double()))
        else:
            gap = abs(float(torch.linalg.vector_norm(prog[k].double())) - ref_norm[k])
        out[k] = gap / max(ref_norm[k], med, 1e-30)
    return out


def kept_leaves(ref: dict):
    """The leaves whose reference gradient is not nought to rounding: at
    least a thousandth of the median leaf's among those not exactly zero."""
    n = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref["grad0"].items()}
    med = _median([v for v in n.values() if v > 0])
    return {k for k, v in n.items() if v >= ZERO_GRAD * med and v > 0}


def ulp_norm(values: torch.Tensor) -> float:
    """The norm of the float32 ulps of ``values``: the spacing of float32
    at each element's magnitude."""
    a = values.detach().to("cpu", torch.float32).abs()
    return float(torch.linalg.vector_norm((torch.nextafter(a, torch.full_like(a, math.inf))
                                           - a).double()))


def moving_leaves(ref: dict, keep) -> set:
    """Of ``keep``, the key encoder's leaves whose reference move is at
    least ``EMA_ULPS`` float32 ulps of their values."""
    return {k for k in keep if k in ref["ema"] and float(torch.linalg.vector_norm(
        ref["ema"][k])) >= EMA_ULPS * ref["ema_ulp"][k]}


def _rel(p: float, r: float) -> float:
    return abs(p - r) / max(abs(r), 1e-30) if math.isfinite(p) else math.inf


def readings(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers that can be compared, from each side's ``loss`` (per
    step), ``grad0`` and ``change`` (per leaf, on the host; the change over
    the leaves whose reference gradient is not nought): ``loss`` the
    largest relative gap of a step's loss and ``loss0`` the first step's;
    ``grad`` and ``change`` the worst leaf's gap of norms and ``*_median``
    the median leaf's; ``grad_diff`` the worst leaf's norm of the
    gradient's difference; ``loader`` the loader's difference where the
    cell reads files.
    """
    gaps = [_rel(p, r) for p, r in zip(prog["loss"], ref["loss"])]
    out = {"loss": max(gaps), "loss0": gaps[0]}
    keep = kept_leaves(ref)
    pairs = [("grad", "grad0", None), ("change", "change", keep)]
    if "ema" in ref and "ema" in prog:
        pairs.append(("ema", "ema", moving_leaves(ref, keep)))
    for name, key, kept in pairs:
        values = list(leaf_gaps(prog[key], ref[key], kept).values())
        bad = not all(math.isfinite(v) for v in values)
        out[name] = math.inf if bad else max(values)
        out[f"{name}_median"] = math.inf if bad else _median(values)
    diffs = leaf_gaps(prog["grad0"], ref["grad0"], of_difference=True).values()
    out["grad_diff"] = max(diffs) if all(math.isfinite(v) for v in diffs) else math.inf
    if "loader" in prog:
        out["loader"] = prog["loader"]
    return out


def verdict(values: Dict[str, float], limits: Dict[str, float]):
    """(correct, ``{name: {"value", "limit"}}``) over the numbers that
    ``limits`` names."""
    checks = {k: {"value": values[k], "limit": v} for k, v in limits.items() if k in values}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def side(loss, grad0: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
         p0: Dict[str, torch.Tensor], ema: Optional[Dict[str, torch.Tensor]] = None) -> dict:
    """One side's readings, on the host: its losses, its first gradient and
    each leaf's change from ``p0`` to ``params`` (and to ``ema``, the key
    encoder, where there is one, with the norm of each leaf's float32
    ulps at the larger magnitude of its start and its end), in float64."""
    def moved(to):
        return {k: host_copy(v).double() - host_copy(p0[k]).double() for k, v in to.items()}

    out = {"loss": [float(v) for v in loss],
           "grad0": {k: host_copy(v) for k, v in grad0.items()},
           "change": moved(params)}
    if ema is not None:
        out["ema"] = moved(ema)
        out["ema_ulp"] = {k: ulp_norm(torch.maximum(host_copy(p0[k]).abs(),
                                                    host_copy(v).abs()))
                          for k, v in ema.items()}
    return out
