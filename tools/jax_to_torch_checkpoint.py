"""Convert a pretrain checkpoint of the JAX package into a pretrain run
directory of the PyTorch port.

The port's finetune reads no orbax checkpoint.  This tool restores one
with ``cp2_tpu.checkpoint.restore_checkpoint`` (on the CPU), carries its
weights through the flax→torch bridge (``cp2_tpu_torch/checkpoint/
bridge.py``) into the port's ``PretrainState`` (both encoders with their
BatchNorm statistics, both queues and their pointers, the step) and writes
it with the port's ``save_checkpoint``: ``<out>/<step>/state.pt`` and
``meta.json`` (the JAX run's epoch, pretrain type and backbone type), and
the ``latest`` link.  The optimizer's momentum is not carried: the state
holds a fresh optimizer, as the bridge leaves it.  Then

    python -m cp2_tpu_torch.train.finetune ... --pretrain_type CP2 --pretrain_path <out>

finetunes from it.  It is the one file of the port that imports both
packages, so it lives outside ``cp2_tpu_torch``.

Usage: ``python tools/jax_to_torch_checkpoint.py --src <JAX run dir or
step dir> --out <dir> [--config <the pretrain run's model config>]``
(``--config`` defaults to the port's ``configs/config_pretrain.py``, the
JAX CLI's default; a config that does not match the weights fails the
bridge's strict load).
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--src", required=True,
                   help="a JAX pretrain run directory (its latest checkpoint) or one "
                        "step directory")
    p.add_argument("--out", required=True, help="the port's run directory to write")
    p.add_argument("--config", default=None, help="the pretrain run's model config")
    p.add_argument("--unet_truncated_dec_blocks", default=2, type=int)
    p.add_argument("--img_height", default=224, type=int)
    p.add_argument("--img_width", default=224, type=int)
    return p.parse_args(argv)


def convert(src: str, out: str, config: str | None = None, *,
            unet_truncated_dec_blocks: int = 2, img_hw=(224, 224)) -> str:
    """Write ``src``'s checkpoint as a port checkpoint under ``out``;
    returns its directory."""
    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    from cp2_tpu.checkpoint import latest_checkpoint, restore_checkpoint

    import cp2_tpu_torch
    from cp2_tpu_torch.checkpoint import save_checkpoint
    from cp2_tpu_torch.checkpoint.bridge import load_pretrain_state_from_flax
    from cp2_tpu_torch.config import Config
    from cp2_tpu_torch.ssl import SSLEncoder, SSLHyperParams, create_pretrain_state
    from cp2_tpu_torch.ssl.train_step import make_optimizer
    from cp2_tpu_torch.types import BackboneType, PretrainType

    path = src if os.path.isdir(os.path.join(src, "state")) else latest_checkpoint(src)
    if path is None:
        raise FileNotFoundError(f"no JAX checkpoint under {src}")
    # no target: the arrays come back as saved, as numpy, in the state's
    # field names (the optimizer's state is read and left)
    tree, meta = restore_checkpoint(path, None)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    pretrain_type = PretrainType[meta.get("pretrain_type", "CP2")]
    backbone_type = BackboneType[meta.get("backbone_type", "DEEPLABV3")]
    config = config or os.path.join(os.path.dirname(cp2_tpu_torch.__file__), "configs",
                                    "config_pretrain.py")
    queue_len, dim = tree["queue"].shape
    hp = SSLHyperParams.for_variant(pretrain_type, queue_len=int(queue_len), dim=int(dim),
                                    backbone_type=backbone_type,
                                    unet_truncated_dec_blocks=unet_truncated_dec_blocks)
    model = SSLEncoder(dict(Config.fromfile(config).model), pretrain_type=pretrain_type,
                       backbone_type=backbone_type, dim=hp.dim,
                       unet_truncated_dec_blocks=unet_truncated_dec_blocks, img_hw=img_hw)
    state = create_pretrain_state(model, make_optimizer("sgd", 0.03), hp, device="cpu")
    load_pretrain_state_from_flax(state, tree)
    return save_checkpoint(out, state.step, state, meta={
        "epoch": meta.get("epoch", 0), "pretrain_type": pretrain_type.name,
        "backbone_type": backbone_type.name, "converted_from": os.path.abspath(path)})


def main(argv=None):
    args = get_args(argv)
    path = convert(args.src, args.out, args.config,
                   unet_truncated_dec_blocks=args.unet_truncated_dec_blocks,
                   img_hw=(args.img_height, args.img_width))
    print(f"wrote {path}")


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
