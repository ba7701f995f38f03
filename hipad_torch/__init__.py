"""hipad_torch: HiP-AD in PyTorch (the streaming forward, training, the
closed-loop agent and open-loop evaluation), with hand-written CUDA kernels
for the deformable sampler and its gradient on an NVIDIA Hopper card
(sm_90a).

The JAX package ``hipad_tpu`` is the reference; this package imports nothing
of it and keeps its own copies of its numpy modules (configuration, data,
metrics):

    from hipad_torch.configs.model import stage2, tiny
    from hipad_torch.data import synthetic
    from hipad_torch.models.detector import HiPAD          # built on the card by default
    from hipad_torch.train.train_step import make_train_step
    from hipad_torch.weights import from_jax, to_jax, init_random

A CPU tensor always takes the plain PyTorch path; a CUDA tensor takes the
hand-written kernels in ``hipad_torch/csrc`` (built with nvcc on first use).
"""

__version__ = "0.2.0"
