"""The whole port (``HiPAD`` at ``tiny()``, bs=2) against the JAX package
over a two-frame episode, and the weight mapping between the two.

Frame 1 runs with ``bank_states=None``, frame 2 with the banks each package
returned. Weights: the port's seeded init with random norms and running
statistics, carried to flax with ``to_jax``. fp32 on both sides on the CPU.
"""

import dataclasses
import os
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipad_torch.configs.model import tiny
from hipad_torch.data import synthetic
from hipad_tpu.models.detector import HiPAD as JHiPAD
from hipad_torch.models.common import BatchNorm, Scale
from hipad_torch.models.detector import META_KEYS, HiPAD, batch_to_torch
from hipad_torch.weights import from_jax, init_random, to_jax

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

# Ten-odd layers of the same fp32 arithmetic summed in other orders
# (convolutions, attention, sampler): |diff| <= RTOL * max|ref| + ATOL.
RTOL, ATOL = 1e-4, 1e-5


def _port(cfg, seed=0):
    model = init_random(HiPAD(cfg, device="cpu"), seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.LayerNorm, BatchNorm, Scale)):
                m.weight.copy_(1 + 0.1 * torch.randn(m.weight.shape, generator=g))
            if isinstance(m, BatchNorm):
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=g))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=g))
    return model


def _leaves(tree, prefix=""):
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _bank_leaves(banks):
    for name in ("det", "ego", "plan"):
        state = getattr(banks, name)
        for f in dataclasses.fields(state):
            yield f"{name}.{f.name}", getattr(state, f.name)


def test_two_frame_episode_matches_jax():
    cfg = tiny(decoder_remat=False)  # remat changes nothing in a forward
    batch = synthetic.make_batch(cfg, 2, seed=3)
    model = _port(cfg)
    images, metas = batch_to_torch(batch, "cpu")
    metas2 = dict(metas, timestamp=metas["timestamp"] + 0.5)
    with torch.no_grad():
        t1, tb1 = model(images, metas)
        t2, tb2 = model(images + 0.1, metas2, tb1)

    jm = JHiPAD(cfg)
    variables = jax.tree_util.tree_map(jnp.asarray, to_jax(model.state_dict()))
    jmetas = {k: jnp.asarray(batch[k]) for k in META_KEYS}
    jimages = jnp.asarray(batch["images"])
    step = jax.jit(jm.apply)
    j1, jb1 = step(variables, jimages, jmetas)
    j2, jb2 = step(variables, jimages + 0.1, dict(jmetas, timestamp=jmetas["timestamp"] + 0.5),
                   jb1)

    checked = 0
    for frame, (tout, jout, tb, jb) in enumerate(((t1, j1, tb1, jb1), (t2, j2, tb2, jb2))):
        jleaves = dict(_leaves(jax.tree_util.tree_map(np.asarray, jout)))
        tleaves = dict(_leaves(tout))
        assert set(tleaves) == set(jleaves), (frame, set(tleaves) ^ set(jleaves))
        pairs = [(f"out.{k}", tleaves[k], jleaves[k]) for k in sorted(jleaves)]
        jbank = {f"{n}.{f.name}": np.asarray(getattr(getattr(jb, n), f.name))
                 for n in ("det", "ego", "plan")
                 for f in dataclasses.fields(getattr(tb, n))}
        pairs += [(f"bank.{k}", v, jbank[k]) for k, v in _bank_leaves(tb)]
        for name, got, ref in pairs:
            got = got.detach().numpy()
            assert got.shape == ref.shape, (frame, name, got.shape, ref.shape)
            if np.issubdtype(ref.dtype, np.integer) or ref.dtype == bool:
                np.testing.assert_array_equal(got, ref, err_msg=f"frame {frame + 1} {name}")
            else:
                err = np.abs(got.astype(np.float64) - ref).max()
                tol = RTOL * np.abs(ref).max() + ATOL
                assert err <= tol, f"frame {frame + 1} {name}: {err:.3e} > {tol:.3e}"
            checked += 1
    # every per-layer stack, final_waypoints and every bank tensor, both frames
    assert checked == 2 * (12 + 14)


def test_weights_round_trip_is_bit_exact():
    """from_jax(to_jax(state_dict)) returns every tensor bit for bit, and
    to_jax(from_jax(variables)) every leaf."""
    cfg = tiny()
    sd = _port(cfg, seed=5).state_dict()
    back = from_jax(to_jax(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    variables = to_jax(sd)
    again = to_jax(from_jax(variables))
    flat_a = dict(_leaves(variables))
    flat_b = dict(_leaves(again))
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        np.testing.assert_array_equal(flat_a[k], flat_b[k], err_msg=k)


def test_weights_cover_every_flax_leaf():
    """The port's state_dict, through to_jax, has exactly the flax model's
    leaves with their shapes, depth head included (the training tree,
    initialised with ``return_depth=True`` as ``create_train_state`` does):
    no JAX leaf is left unset, none is extra."""
    cfg = tiny()
    batch = synthetic.make_batch(cfg, 1)
    jm = JHiPAD(cfg)
    shapes = jax.eval_shape(
        lambda r: jm.init(r, jnp.asarray(batch["images"]),
                          {k: jnp.asarray(batch[k]) for k in META_KEYS}, return_depth=True),
        jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in _leaves(shapes)}
    got = {k: tuple(v.shape) for k, v in _leaves(to_jax(HiPAD(cfg, device="cpu").state_dict()))}
    assert got.keys() == want.keys(), sorted(set(got) ^ set(want))[:10]
    assert got == want


@pytest.mark.parametrize("knob", [
    {"with_topk_det": True, "topk_det_list": (6, 6)},  # prunes at the merge layer
    {"sampler_row_packed": True},
    {"fused_deformable": True},
])
def test_knobs_outside_stage2_are_refused(knob):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        HiPAD(tiny(**knob), device="cpu")


# every model option of the port on, in the two sets the configuration
# allows together (the concat expansion refuses the masks)
WITH_OPTIONS = {
    "masks_deform_level_k": dict(with_distance_attn_mask=True, with_velocity_attn_mask=True,
                                 with_deform_map_points=True, with_deform_plan_points=True,
                                 sampler_level_k=1),
    "concat": dict(with_concat_map_points=True, with_concat_plan_points=True),
}


@pytest.mark.parametrize("options", sorted(WITH_OPTIONS))
def test_weights_with_options_cover_every_flax_leaf_and_round_trip(options):
    """With the options on, the port's state_dict through ``to_jax`` has
    exactly the flax model's leaves and shapes (the tau heads, the per-point
    encoders, the squeeze MLPs, the wider weights heads), and ``from_jax``
    returns it bit for bit."""
    cfg = tiny(**WITH_OPTIONS[options])
    batch = synthetic.make_batch(cfg, 1)
    jm = JHiPAD(cfg)
    shapes = jax.eval_shape(
        lambda r: jm.init(r, jnp.asarray(batch["images"]),
                          {k: jnp.asarray(batch[k]) for k in META_KEYS}, return_depth=True),
        jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in _leaves(shapes)}
    sd = _port(cfg, seed=5).state_dict()
    got = {k: tuple(v.shape) for k, v in _leaves(to_jax(sd))}
    assert got.keys() == want.keys(), sorted(set(got) ^ set(want))[:10]
    assert got == want
    back = from_jax(to_jax(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


def test_det_pruning_after_the_last_layer_is_refused():
    """A prune at the end of the last refine layer reaches no later layer;
    the JAX package then splices the new tails into that layer's unpruned
    cls for the bank cache (ROADMAP queue 3). The port refuses it, and runs
    the same schedule held one layer earlier."""
    from hipad_torch.configs.model import SINGLE_FRAME_LAYER, TEMPORAL_FRAME_LAYER

    order = SINGLE_FRAME_LAYER + TEMPORAL_FRAME_LAYER * 2
    with pytest.raises(NotImplementedError, match="ROADMAP queue 3"):
        HiPAD(tiny(with_topk_det=True, topk_det_list=(12, 12, 6), operation_order=order),
              device="cpu")
    HiPAD(tiny(with_topk_det=True, topk_det_list=(12, 6, 6), operation_order=order), device="cpu")
