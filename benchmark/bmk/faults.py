"""Faults planted under the timed path, for the check's own tests and the
readings its limits are set from.  Each breaks the program's step where a
change to the program could break it; the check must call every one of
them not correct.

* ``half_batch``: half of each batch left out, the mean over the rest;
* ``frozen``: a step that leaves the weights as they were;
* ``conv_roll``: the 3x3 convolutions of layer 4's residual branches (two
  of them dilated) read their taps one pixel off, in both encoders, as a
  faulty kernel for those shapes would;
* ``ema_skipped`` (CP2): the key encoder is never moved toward the query
  encoder.
"""

from __future__ import annotations

FAULTS = ("half_batch", "frozen", "conv_roll", "ema_skipped")
ROLLED = ("backbone.layer4_0.conv2", "backbone.layer4_1.conv2", "backbone.layer4_2.conv2")


def roll_conv(model) -> None:
    """Each of ``ROLLED``'s outputs one column off.  BatchNorm and ReLU
    commute with the roll, so this is its convolution's output rolled."""
    for name, module in model.named_modules():
        if name.endswith(ROLLED):
            module.register_forward_hook(lambda mod, args, out: out.roll(1, dims=-1))
