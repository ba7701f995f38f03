# Frozen copy of hipad_torch/models/depth_net.py at commit 795f982 for the benchmark's plain
# reference; see bench_h100/reference/__init__.py for the departures.
"""Dense depth auxiliary head (counterpart of ``hipad_tpu/models/depth_net.py``;
training-time supervision only; its loss is ``losses/depth.py``).

A 1x1 convolution per FPN level predicts exp-depth, scaled by
``focal / equal_focal``, in fp32, also under autocast.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


class DenseDepthNet(nn.Module):
    def __init__(self, embed_dims: int, num_depth_layers: int = 3,
                 equal_focal: float = 100.0):
        super().__init__()
        self.num_depth_layers, self.equal_focal = num_depth_layers, equal_focal
        for i in range(num_depth_layers):
            self.add_module(f"depth_conv_{i}", nn.Conv2d(embed_dims, 1, 1))

    def forward(self, feature_maps: Sequence[torch.Tensor],
                focal: Optional[torch.Tensor] = None):
        """feature_maps: per-level ``[bs, cams, H, W, C]``; focal ``[bs, cams]``
        -> per-level ``[bs, cams, H, W, 1]`` depths."""
        depths = []
        with torch.autocast(feature_maps[0].device.type, enabled=False):
            for i, feat in enumerate(feature_maps[:self.num_depth_layers]):
                bs, cams = feat.shape[:2]
                conv = getattr(self, f"depth_conv_{i}")
                x = feat.reshape((bs * cams,) + feat.shape[2:]).float()
                d = torch.exp(F.conv2d(x.permute(0, 3, 1, 2), conv.weight.float(),
                                       conv.bias.float()))
                if focal is not None:
                    d = d * (focal.reshape(-1).float()[:, None, None, None] / self.equal_focal)
                depths.append(d.permute(0, 2, 3, 1).reshape((bs, cams) + d.shape[2:] + (1,)))
        return depths
