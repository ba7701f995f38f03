"""The distance and velocity attention biases (``with_distance_attn_mask``,
``with_velocity_attn_mask``) of the port against the JAX package on the
CPU: the four functions of ``models/attn_masks.py`` and the tau head as
``tests/test_attn_masks.py`` holds JAX's, the grouped attention taking a
group's bias, and two-frame ``HiPAD`` episodes at ``tiny()`` with both
masks on, in fp32 and in bf16.

Inputs are drawn with numpy from a seed; fp32 unless stated.
"""

import os

import numpy as np
import torch

from hipad_torch.configs.model import tiny
from hipad_torch.models import attention_blocks as tattn
from hipad_torch.models import attn_masks as tmask
from hipad_tpu.models import attn_masks as jmask
from test_torch_bf16 import bf16_episode
from test_torch_port_modules import (BS, CFG, C, _JGroupedAttention, _TGroupedAttention, _close,
                                     _j, _port, _t, _vars)
from test_torch_serve_model import _episode, assert_episode_matches

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

MASKS = dict(with_distance_attn_mask=True, with_velocity_attn_mask=True)
Q_NAMES, K_NAMES = ("plan", "ego"), ("det", "map")


def _anchors(rng):
    """det and ego boxes (11 numbers, velocity at 8:10), map polylines of 5
    points and plan trajectories of 4, as numpy."""
    return {"det": rng.normal(0, 5, (BS, 7, 11)).astype(np.float32),
            "ego": rng.normal(0, 2, (BS, 1, 11)).astype(np.float32),
            "map": rng.normal(0, 5, (BS, 3, 10)).astype(np.float32),
            "plan": rng.normal(0, 5, (BS, 4, 8)).astype(np.float32)}


def test_min_distance_matrix_levels():
    """JAX's hand-made case (point to point, point to polyline vertex), and
    random anchors of every (query, key) level pair against JAX."""
    anchors = {
        "det": torch.tensor([[[0.0, 0.0] + [0.0] * 9, [10.0, 0.0] + [0.0] * 9]]),
        "ego": torch.tensor([[[0.0, 3.0] + [0.0] * 9]]),
        "map": torch.tensor([[[0.0, 0.0, 0.0, 4.0]]]),
        "plan": torch.tensor([[[1.0, 0.0, 2.0, 0.0]]]),
    }
    d = tmask.min_distance_matrix(Q_NAMES, K_NAMES, anchors)
    assert d.shape == (1, 2, 3)
    np.testing.assert_allclose(float(d[0, 0, 0]), 1.0, atol=1e-6)  # plan -> det 0
    np.testing.assert_allclose(float(d[0, 1, 0]), 3.0, atol=1e-6)  # ego -> det 0
    np.testing.assert_allclose(float(d[0, 1, 2]), 1.0, atol=1e-6)  # ego -> map vertex
    a = _anchors(np.random.default_rng(1))
    for q, k in ((Q_NAMES, K_NAMES), (("det", "map"), ("plan", "ego"))):
        _close(tmask.min_distance_matrix(q, k, {n: _t(v) for n, v in a.items()}),
               jmask.min_distance_matrix(q, k, {n: _j(v) for n, v in a.items()}),
               f"min_distance_matrix {q} -> {k}")


def test_speed_diff_matrix_matches_jax():
    """Query speed minus key speed, shifted by the batch's largest value:
    non-positive, and JAX's."""
    a = _anchors(np.random.default_rng(2))
    got = tmask.speed_diff_matrix(Q_NAMES + ("det",), K_NAMES, {n: _t(v) for n, v in a.items()})
    assert float(got.max()) <= 1e-6
    _close(got, jmask.speed_diff_matrix(Q_NAMES + ("det",), K_NAMES,
                                        {n: _j(v) for n, v in a.items()}),
           "speed_diff_matrix")


def test_tau_head_and_biases_match_jax():
    """``TauHead`` (a Linear to the heads and a softplus) against flax's on
    the same weights, then ``distance_bias`` and ``velocity_bias`` of it."""
    rng = np.random.default_rng(3)
    q_feat = rng.normal(size=(BS, 5, C)).astype(np.float32)
    head = _port(tmask.TauHead(C, CFG.num_groups))
    got = head(_t(q_feat))
    ref = jmask.TauHead(CFG.num_groups).apply(_vars(head), _j(q_feat))
    _close(got, ref, "TauHead")
    dist = rng.uniform(0, 30, (BS, 5, 9)).astype(np.float32)
    _close(tmask.distance_bias(_t(dist), got), jmask.distance_bias(_j(dist), ref),
           "distance_bias")
    _close(tmask.velocity_bias(-_t(dist), got), jmask.velocity_bias(-_j(dist), ref),
           "velocity_bias")


def test_pair_ban_bias_matches_jax():
    sections = {"det": (0, 6), "map": (6, 9), "plan": (9, 13), "ego": (13, 14)}
    banned = (("plan", "map"), ("ego", "det"))
    got = tmask.pair_ban_bias(Q_NAMES, K_NAMES, sections, sections, banned)
    ref = jmask.pair_ban_bias(Q_NAMES, K_NAMES, sections, sections, banned)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got == -1e9).sum() == 4 * 3 + 1 * 6


def test_grouped_attention_takes_a_group_bias():
    """The inter_gnn flavour with a ``[bs, heads, Nq, Nk]`` bias for its one
    group, against flax's ``attn_bias``; the bias moves the output."""
    rng = np.random.default_rng(4)
    counts = {"det": 6, "map": 3, "plan": 4, "ego": 1}
    sections, s = {}, 0
    for q in CFG.query_select:
        sections[q] = (s, s + counts[q])
        s += counts[q]
    x, pos = (rng.normal(size=(BS, s, C)).astype(np.float32) for _ in range(2))
    bias = rng.normal(0, 3, (BS, CFG.num_groups, 5, 9)).astype(np.float32)
    groups = tattn.cross_attention_groups([Q_NAMES], [K_NAMES], [False])
    m = _port(_TGroupedAttention(groups))
    got = m(_t(x), _t(pos), sections, key_x=_t(x), key_pos=_t(pos), key_sections=sections,
            attn_bias={0: _t(bias)})
    ref = _JGroupedAttention(groups).apply(_vars(m), _j(x), _j(pos), sections, key_x=_j(x),
                                           key_pos=_j(pos), key_sections=sections,
                                           attn_bias={0: _j(bias)})
    _close(got, ref, "GroupedCrossAttention[inter] with a bias")
    plain = m(_t(x), _t(pos), sections, key_x=_t(x), key_pos=_t(pos), key_sections=sections)
    assert (got - plain).abs().max() > 1e-3


def test_two_frame_episode_with_masks_matches_jax():
    """``tiny()`` with both masks, two frames: every output stack and bank
    tensor within the episode tolerance; the tau heads' parameters are the
    ones the JAX tree has."""
    cfg = tiny(decoder_remat=False, **MASKS)
    frames = _episode(cfg)
    assert_episode_matches(frames)
    from hipad_torch.models.detector import HiPAD

    names = set(HiPAD(cfg, device="cpu").decoder.state_dict())
    for op_idx, op in enumerate(cfg.operation_order):
        if op == "inter_gnn":
            assert {f"distance_tau_{op_idx}.tau.weight",
                    f"velocity_tau_{op_idx}.tau.weight"} <= names


def test_two_frame_episode_with_masks_matches_jax_bf16():
    """The same episode under bf16 autocast against the JAX package's bf16,
    held to ``tests/test_torch_bf16.py``'s rule (twice JAX's own bf16/fp32
    spread plus the fp32 tolerance); the biases are cast to the logits'
    dtype as JAX casts them."""
    bf16_episode(tiny(decoder_remat=False, **MASKS))
