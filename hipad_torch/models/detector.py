"""Top-level HiP-AD model: six cameras in, multi-task predictions and the new
temporal banks out (counterpart of ``hipad_tpu/models/detector.py``, the
eval forward at ``stage2()`` semantics).

    model = HiPAD(cfg, device="cuda").eval()
    init_random(model, seed=0)                     # or load_state_dict(from_jax(...))
    outputs, banks = model(images, metas)          # first frame
    outputs, banks = model(images, metas, banks)   # banks carried frame to frame
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from .backbone import ResNetFPN
from .decoder import SparseOneDecoder
from .instance_bank import BankStates

# The per-frame metadata the forward reads (``hipad_tpu/train/train_step.py``).
META_KEYS = (
    "timestamp", "projection_mat", "image_wh", "T_global", "T_global_inv",
    "target_point", "gt_ego_fut_cmd", "focal",
)


def batch_to_torch(batch: Mapping[str, np.ndarray], device) -> tuple:
    """A ``hipad_tpu.data.synthetic.make_batch`` dict -> (images, metas) on
    ``device``."""
    images = torch.as_tensor(batch["images"], device=device)
    metas = {k: torch.as_tensor(batch[k], device=device) for k in META_KEYS}
    return images, metas


class HiPAD(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        with torch.device(device or "cpu"):
            self.backbone = ResNetFPN(cfg.backbone_stage_blocks, cfg.backbone_base_planes,
                                      cfg.embed_dims)
            self.decoder = SparseOneDecoder(cfg)
        self.to(memory_format=torch.channels_last)
        self.eval()

    def forward(self, images: torch.Tensor, metas: Dict[str, torch.Tensor],
                bank_states: Optional[BankStates] = None):
        """images ``[bs, cams, H, W, 3]``; metas as ``META_KEYS``;
        ``bank_states=None`` on the first frame -> (outputs, new bank states)."""
        feature_maps = self.backbone(images)
        return self.decoder(feature_maps, metas, bank_states)
