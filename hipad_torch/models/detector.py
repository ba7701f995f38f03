"""Top-level HiP-AD model: six cameras in, multi-task predictions and the new
temporal banks out (counterpart of ``hipad_tpu/models/detector.py`` at
``stage2()`` semantics).

    model = init_random(HiPAD(cfg), seed=0)        # on the card; or load_state_dict(from_jax(...))
    outputs, banks = model(images, metas)          # first frame
    outputs, banks = model(images, metas, banks)   # banks carried frame to frame

The model is built on the card (``device="cuda"``) unless the caller asks
for another device. It starts in eval mode. In train mode (``model.train()``,
as ``train.train_step`` runs it) GridMask, dropout and BatchNorm's batch
statistics are on, and the random draws come from the ``generator`` passed
to the forward.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..utils.spans import span
from .backbone import ResNetFPN
from .common import BatchNorm
from .decoder import SparseOneDecoder
from .depth_net import DenseDepthNet
from .grid_mask import draw_grid_mask, grid_mask
from .instance_bank import BankStates

# The per-frame metadata the forward reads (``hipad_tpu/train/train_step.py``).
META_KEYS = (
    "timestamp", "projection_mat", "image_wh", "T_global", "T_global_inv",
    "target_point", "gt_ego_fut_cmd", "focal",
)


def batch_to_torch(batch: Mapping[str, np.ndarray], device) -> tuple:
    """A ``data.synthetic.make_batch`` dict -> (images, metas) on ``device``."""
    images = torch.as_tensor(batch["images"], device=device)
    metas = {k: torch.as_tensor(batch[k], device=device) for k in META_KEYS}
    return images, metas


class HiPAD(nn.Module):
    def __init__(self, cfg, device="cuda", group=None):
        """``group``: the ``torch.distributed`` process group whose processes
        hold the global batch between them in training (``parallel/mesh.py``):
        every BatchNorm then takes its train-mode statistics over their
        batches. None: this process's batch alone."""
        super().__init__()
        self.cfg, self.group = cfg, group
        with torch.device(device):
            self.backbone = ResNetFPN(cfg.backbone_stage_blocks, cfg.backbone_base_planes,
                                      cfg.embed_dims)
            self.decoder = SparseOneDecoder(cfg)
            self.depth_net = DenseDepthNet(cfg.embed_dims, cfg.num_depth_layers)
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.group = group
        self.to(memory_format=torch.channels_last)
        self.eval()

    @span("forward")
    def forward(self, images: torch.Tensor, metas: Dict[str, torch.Tensor],
                bank_states: Optional[BankStates] = None,
                generator: Optional[torch.Generator] = None, return_depth: bool = False):
        """images ``[bs, cams, H, W, 3]``; metas as ``META_KEYS``;
        ``bank_states=None`` on the first frame -> (outputs, new bank states).
        ``return_depth`` adds ``outputs["depth"]``, the depth head's
        per-level predictions."""
        if self.training and self.cfg.use_grid_mask:
            if generator is None:
                raise ValueError("train mode draws GridMask from an explicit torch.Generator: "
                                 "pass generator=")
            images = grid_mask(images, *draw_grid_mask(generator, images.shape[-3]))
        with span("backbone"):
            feature_maps = self.backbone(images)
        if self.cfg.stop_fmap_gradient:
            feature_maps = [f.detach() for f in feature_maps]
        with span("decoder"):
            outputs, new_banks = self.decoder(feature_maps, metas, bank_states, generator)
        if return_depth:
            with span("depth"):
                outputs["depth"] = self.depth_net(feature_maps, metas.get("focal"))
        return outputs, new_banks
