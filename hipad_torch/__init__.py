"""hipad_torch: the HiP-AD streaming forward in PyTorch, with CUDA kernels for
the deformable sampler on an NVIDIA Hopper card (sm_90a).

The JAX package ``hipad_tpu`` is the reference. The port shares its numpy-only
configuration and synthetic-data modules and imports nothing else from it:

    from hipad_tpu.configs.model import stage2, tiny
    from hipad_torch.models.detector import HiPAD
    from hipad_torch.weights import from_jax, to_jax, init_random

A CPU tensor always takes the plain PyTorch path; a CUDA tensor takes the
hand-written kernels in ``hipad_torch/csrc`` (built with nvcc on first use).
"""

__version__ = "0.1.0"
