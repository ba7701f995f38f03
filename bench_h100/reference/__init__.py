"""The plain reference that decides ``correct``: plain PyTorch in float32
(TF32 off where it runs on the card) and NumPy, importing nothing of
``hipad_torch``, ``hipad_tpu`` or JAX.

``hipad/`` is a frozen copy of the port's plain paths at commit 795f982
(``hipad_torch/``: ``agent/calib.py``, ``configs/model.py``, ``core/box3d.py``, ``core/geometry.py``,
``data/pipelines.py``, ``models/{attention_blocks,attn_masks,backbone,
common,decoder,deformable,depth_net,detector,encoders,grid_mask,
instance_bank,keypoints,refine}.py``, ``ops/ranking.py``,
``ops/sampling.py``, ``postprocess/{__init__,det,map,plan}.py``), each file
headed by its origin. The departures: ``ops/sampling.py`` has no dispatch to
the CUDA kernels (its ``_CoarseSample``, ``_PatchSample`` and
``coarse_sample_backward`` are gone), so ``coarse_sample`` and
``patch_sample`` take their plain versions on every device.
``fp8.py`` is the control's precision.
"""
