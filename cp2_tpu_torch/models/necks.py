"""Projection necks for the SSL variants.

Port of ``cp2_tpu/models/necks.py``:

* ``DenseCLNeck`` — parallel global (fc-relu-fc) and dense (1x1conv-relu-
  1x1conv) projectors with predictor twins (reference builder.py:179-274),
  returning the same six named projections, so that the DenseCL /
  PROPOSED_V2 losses select by ``use_predictor`` / ``use_avgpool_global``
  as the reference does (builder.py:700-758).
* ``GlobalProjector`` — the MoCo/BYOL projector on the flattened last
  backbone stage (reference builder.py:404-429).

flax infers a dense layer's input width at its first call; ``nn.Linear``
needs it up front, so both take it: ``in_channels`` of the backbone map,
and for ``GlobalProjector`` the flattened width C·h·w, which depends on
the image size.  Flattening and the local maps follow the flax module's
NHWC order (the input arrives NCHW and is permuted first), so a bridged
flax ``fc1`` kernel loads with the plain transpose.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from cp2_tpu_torch.models.layers import MLP, ConvMLP
from cp2_tpu_torch.models.registry import NECKS


def _last(x):
    return x[-1] if isinstance(x, (tuple, list)) else x


@NECKS.register
class DenseCLNeck(nn.Module):
    def __init__(self, in_channels: int = 2048, hid_channels: int = 2048,
                 out_channels: int = 128, num_grid: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.global_projector = MLP(in_channels, hid_channels, out_channels, dtype=dtype)
        self.global_predictor = MLP(out_channels, hid_channels, out_channels, dtype=dtype)
        self.local_projector = ConvMLP(in_channels, hid_channels, out_channels, dtype=dtype)
        self.local_predictor = ConvMLP(out_channels, hid_channels, out_channels, dtype=dtype)
        self.num_grid = num_grid
        self.dtype = dtype

    def forward(self, x) -> Dict[str, torch.Tensor]:
        """(N, C, H, W) map (or a backbone tuple: its last stage) → the six
        projections: global ones (N, out), local ones (N, h, w, out) NHWC."""
        x = _last(x).to(self.dtype)
        x_global_proj = self.global_projector(x.mean(dim=(2, 3)))
        x_global_pred = self.global_predictor(x_global_proj)
        if self.num_grid is not None:
            # adaptive average pool to (num_grid, num_grid)
            n, c, h, w = x.shape
            g = self.num_grid
            x = x.reshape(n, c, g, h // g, g, w // g).mean(dim=(3, 5))
        x_local_proj = self.local_projector(x)
        x_local_pred = self.local_predictor(x_local_proj)
        return {
            "x_global_proj": x_global_proj,
            "x_global_pred": x_global_pred,
            "x_local_proj": x_local_proj.permute(0, 2, 3, 1),
            "x_local_pred": x_local_pred.permute(0, 2, 3, 1),
            "x_avgpool_local_proj": x_local_proj.mean(dim=(2, 3)),
            "x_avgpool_local_pred": x_local_pred.mean(dim=(2, 3)),
        }


@NECKS.register
class GlobalProjector(nn.Module):
    """Flatten the last backbone stage (h, w, c order) and project."""

    def __init__(self, in_features: int, hidden: int = 2048, out: int = 256,
                 use_bn: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mlp = MLP(in_features, hidden, out, use_bn=use_bn, dtype=dtype)
        self.dtype = dtype

    def forward(self, feats) -> torch.Tensor:
        x = _last(feats).to(self.dtype)
        return self.mlp(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))
