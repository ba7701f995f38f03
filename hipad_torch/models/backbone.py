"""ResNet + FPN image backbone (counterpart of ``hipad_tpu/models/backbone.py``).

torchvision-style bottleneck ResNet ("pytorch" style: stride on the 3x3),
mmdet-style FPN: 1x1 laterals with bias, nearest 2x top-down upsample cropped
to the lateral's size, 3x3 output convs followed by BatchNorm. BatchNorm runs
in eval mode with epsilon 1e-5.

Inside, tensors are NCHW in ``torch.channels_last`` memory, so
``permute(0, 2, 3, 1)`` of each output is already a contiguous NHWC view.

Spans (``utils/spans.py``), one each a frame under the caller's
``backbone``: ``backbone.stem``, ``backbone.layer1`` to ``backbone.layer4``
(a stage's blocks), ``backbone.fpn``.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.spans import span
from .common import BatchNorm


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm(planes * 4)
        if downsample:
            self.downsample_conv = nn.Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False)
            self.downsample_bn = BatchNorm(planes * 4)
        else:
            self.downsample_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample_conv is None else self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + identity)


class ResNet(nn.Module):
    """Bottleneck ResNet; stage_blocks (3, 4, 6, 3) at 64 planes is ResNet-50."""

    def __init__(self, stage_blocks: Sequence[int] = (3, 4, 6, 3), base_planes: int = 64):
        super().__init__()
        self.stage_blocks = tuple(stage_blocks)
        self.stem_conv = nn.Conv2d(3, base_planes, 7, stride=2, padding=3, bias=False)
        self.stem_bn = BatchNorm(base_planes)
        inplanes = base_planes
        self.out_channels = []
        for stage, num_blocks in enumerate(self.stage_blocks):
            planes = base_planes * 2 ** stage
            for b in range(num_blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                self.add_module(f"layer{stage + 1}_block{b}",
                                Bottleneck(inplanes, planes, stride, downsample=b == 0))
                inplanes = planes * 4
            self.out_channels.append(inplanes)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        with span("backbone.stem"):
            x = F.relu(self.stem_bn(self.stem_conv(x)))
            x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        for stage, num_blocks in enumerate(self.stage_blocks):
            with span(f"backbone.layer{stage + 1}"):
                for b in range(num_blocks):
                    x = getattr(self, f"layer{stage + 1}_block{b}")(x)
            outs.append(x)
        return outs


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256):
        super().__init__()
        self.n = len(in_channels)
        for i, c in enumerate(in_channels):
            self.add_module(f"lateral_{i}", nn.Conv2d(c, out_channels, 1))
            self.add_module(f"fpn_conv_{i}", nn.Conv2d(out_channels, out_channels, 3,
                                                       padding=1, bias=False))
            self.add_module(f"fpn_bn_{i}", BatchNorm(out_channels))

    def forward(self, inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        laterals = [getattr(self, f"lateral_{i}")(f) for i, f in enumerate(inputs)]
        for i in range(self.n - 1, 0, -1):
            th, tw = laterals[i - 1].shape[2:4]
            # nearest upsampling copies values; the card's autocast would
            # return them in fp32 and make the top-down sums fp32
            up = F.interpolate(laterals[i], scale_factor=2, mode="nearest").to(laterals[i].dtype)
            laterals[i - 1] = laterals[i - 1] + up[:, :, :th, :tw]
        return [getattr(self, f"fpn_bn_{i}")(getattr(self, f"fpn_conv_{i}")(lat))
                for i, lat in enumerate(laterals)]


class ResNetFPN(nn.Module):
    """``[bs, cams, H, W, 3]`` images -> per-level ``[bs, cams, H_l, W_l, C]``
    maps. Cameras ride the batch dimension of the convolutions."""

    def __init__(self, stage_blocks: Sequence[int] = (3, 4, 6, 3), base_planes: int = 64,
                 out_channels: int = 256):
        super().__init__()
        self.resnet = ResNet(stage_blocks, base_planes)
        self.fpn = FPN(self.resnet.out_channels, out_channels)

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        bs, cams = images.shape[:2]
        x = images.reshape((bs * cams,) + images.shape[2:]).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        feats = self.resnet(x)
        with span("backbone.fpn"):
            feats = self.fpn(feats)
        return [f.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
                .reshape((bs, cams) + (f.shape[2], f.shape[3], f.shape[1]))
                for f in feats]
