"""The training path's pieces against the JAX package on the CPU, each from
the same numpy inputs: the Hungarian matching, the det/map/motion/plan
targets, every loss scalar of ``compute_losses``, the depth loss, GridMask
given the same four scalars, BatchNorm in train mode against flax, and the
LR schedule and the AdamW update against optax given the same gradients.
"""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hipad_tpu.losses import hipad_loss as jloss
from hipad_tpu.models import depth_net as jdepth
from hipad_tpu.models import grid_mask as jgrid
from hipad_tpu.targets import det as jdet
from hipad_tpu.targets import map as jmap
from hipad_tpu.targets import matching as jmatching
from hipad_tpu.targets import motion as jmotion
from hipad_tpu.targets import plan as jplan
from hipad_tpu.train import optim as jopt
from hipad_torch.configs.model import tiny
from hipad_torch.data import synthetic
from hipad_torch.losses import hipad_loss as tloss
from hipad_torch.losses import depth as tdepth
from hipad_torch.models import grid_mask as tgrid
from hipad_torch.models.common import BatchNorm
from hipad_torch.targets import det as tdet
from hipad_torch.targets import map as tmap
from hipad_torch.targets import matching as tmatching
from hipad_torch.targets import motion as tmotion
from hipad_torch.targets import plan as tplan
from hipad_torch.train.optim import AdamW, lr_at

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

# fp32 on both sides, the same formulas summed in other orders.
RTOL = 1e-5
L, BS = 2, 2


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(got, ref, what, rtol=RTOL, atol=1e-7):
    got, ref = np.asarray(_np(got), np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max() if ref.size else 0.0
    tol = rtol * (np.abs(ref).max() if ref.size else 0.0) + atol
    assert err <= tol, f"{what}: max_abs_err {err:.3e} > {tol:.3e}"


def _equal(got, ref, what):
    np.testing.assert_array_equal(_np(got), np.asarray(ref), err_msg=what)


@pytest.fixture(scope="module")
def case():
    """tiny() config, a bs=2 synthetic batch and random decoder outputs of
    the shapes the model emits (logits around 0, so that some queries pass
    the regression's confidence threshold)."""
    cfg = tiny()
    batch = synthetic.make_batch(cfg, BS, seed=5)
    rng = np.random.default_rng(6)
    nd, nm = cfg.num_det_anchor, cfg.num_map_anchor
    n_plan = len(cfg.plan_anchor_types) * cfg.ego_fut_cmd * cfg.ego_fut_mode

    def r(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    det_pred = r(L, BS, nd, 11)
    det_pred[..., :3] *= 20.0
    outputs = {
        "det": {"classification": r(L, BS, nd, cfg.num_det_classes, scale=2.0),
                "prediction": det_pred, "quality": r(L, BS, nd, 2)},
        "map": {"classification": r(L, BS, nm, cfg.num_map_classes, scale=2.0),
                "prediction": r(L, BS, nm, cfg.map_num_pts * 2, scale=10.0)},
        "ego": {"status": r(L, BS, 1, cfg.ego_status_dims)},
        "plan": {"classification": r(L, BS, 1, n_plan),
                 "prediction": r(L, BS, 1, n_plan, cfg.ego_fut_ts, 2)},
        "motion": {"classification": r(L, BS, nd, cfg.fut_mode),
                   "prediction": r(L, BS, nd, cfg.fut_mode, cfg.fut_ts, 2, scale=0.5)},
    }
    data = {k: v for k, v in batch.items() if k != "images"}
    return cfg, outputs, data


def _tree(tree, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def test_matching_equals_jax_assign():
    """Random continuous costs (a unique optimum) with a row mask: the host
    solver gives JAX's on-device assignment, and padded rows give -1. All
    problems of one call come back as from single calls."""
    rng = np.random.default_rng(1)
    cost = rng.uniform(-5, 50, (4, 9, 23)).astype(np.float32)
    cost[1, 2, 3] = np.nan
    mask = rng.uniform(size=(4, 9)) < 0.6
    mask[2] = False
    ref = np.asarray(jmatching.assign(jnp.asarray(cost), jnp.asarray(mask)))
    got = tmatching.assign(torch.from_numpy(cost), torch.from_numpy(mask))
    _equal(got, ref, "assign")
    assert (got[~torch.from_numpy(mask)] == -1).all()
    cost2 = rng.uniform(0, 1, (2, 5, 7)).astype(np.float32)
    mask2 = np.ones((2, 5), bool)
    both = tmatching.assign_many([(torch.from_numpy(cost), torch.from_numpy(mask)),
                                  (torch.from_numpy(cost2), torch.from_numpy(mask2))])
    _equal(both[0], ref, "assign_many[0]")
    _equal(both[1], jmatching.assign(jnp.asarray(cost2), jnp.asarray(mask2)), "assign_many[1]")


def test_det_cost_and_targets(case):
    cfg, outputs, data = case
    cls, pred = outputs["det"]["classification"][0], outputs["det"]["prediction"][0]
    args = (data["gt_labels_3d"], data["gt_bboxes_3d"])
    jcost = np.asarray(jdet.det_cost(jnp.asarray(cls), jnp.asarray(pred),
                                     *map(jnp.asarray, args))[0])
    _close(tdet.det_cost(torch.from_numpy(cls), torch.from_numpy(pred),
                         *map(torch.from_numpy, args)), jcost, "det_cost")
    col = jmatching.assign(jnp.asarray(jcost), jnp.asarray(data["gt_valid"]))
    ref = jdet.det_target(jnp.asarray(cls), jnp.asarray(pred), *map(jnp.asarray, args),
                          jnp.asarray(data["gt_valid"]), cfg.num_det_classes, col4gt=col)
    got = tdet.det_target(torch.from_numpy(cls), torch.from_numpy(pred),
                          *map(torch.from_numpy, args), torch.from_numpy(data["gt_valid"]),
                          cfg.num_det_classes, col4gt=torch.from_numpy(np.array(col)))
    for name, a, b in zip(("cls_target", "box_target", "reg_weights", "col4gt"), got, ref):
        _close(a, b, f"det_target {name}")


def test_map_cost_and_targets(case):
    cfg, outputs, data = case
    cls, pred = outputs["map"]["classification"][0], outputs["map"]["prediction"][0]
    args = (data["gt_map_labels"], data["gt_map_pts"])
    jcost, jperm = jmap.map_cost(jnp.asarray(cls), jnp.asarray(pred), *map(jnp.asarray, args),
                                 cfg.map_roi_size)
    tcost, tperm = tmap.map_cost(torch.from_numpy(cls), torch.from_numpy(pred),
                                 *map(torch.from_numpy, args), cfg.map_roi_size)
    _close(tcost, jcost, "map_cost")
    # perm_idx: the first permutation of least cost. Far from a GT line the
    # smooth-L1 sum does not depend on the pairing, so several permutations
    # tie up to rounding, and the two packages may pick different ones of
    # them: hold the port's pick to the least cost, then give both target
    # functions JAX's pick.
    tperm, jperm = tperm.numpy(), np.asarray(jperm)
    pn = tmap.normalize_line(torch.from_numpy(pred).reshape(BS, pred.shape[1], -1, 2),
                             cfg.map_roi_size)
    dist = tmap._smooth_l1(pn[:, :, None, None] - tmap.normalize_line(
        torch.from_numpy(args[1]), cfg.map_roi_size)[:, None], tmap.SMOOTH_L1_BETA).sum((-1, -2))
    at = lambda idx: np.take_along_axis(dist.numpy(), idx[..., None], -1)[..., 0]
    _close(at(tperm), at(jperm), "map_cost perm_idx: cost of the chosen permutation")
    col = jmatching.assign(jcost, jnp.asarray(data["gt_map_valid"]))
    ref = jmap.map_target(jnp.asarray(cls), jnp.asarray(pred), *map(jnp.asarray, args),
                          jnp.asarray(data["gt_map_valid"]), cfg.num_map_classes,
                          cfg.map_roi_size, col4gt=col, perm_idx=jperm)
    got = tmap.map_target(torch.from_numpy(cls), torch.from_numpy(pred),
                          *map(torch.from_numpy, args), torch.from_numpy(data["gt_map_valid"]),
                          cfg.num_map_classes, cfg.map_roi_size,
                          col4gt=torch.from_numpy(np.array(col)),
                          perm_idx=torch.from_numpy(jperm))
    for name, a, b in zip(("cls_target", "pts_target", "reg_weights"), got, ref):
        _close(a, b, f"map_target {name}")


def test_motion_targets(case):
    cfg, outputs, data = case
    reg = outputs["motion"]["prediction"][0]
    col = np.full((BS, data["gt_valid"].shape[1]), -1, np.int32)
    col[:, :5] = np.random.default_rng(7).permutation(cfg.num_det_anchor)[:5]
    args = (reg, data["gt_agent_fut_trajs"], data["gt_agent_fut_masks"], col)
    ref = jmotion.motion_target(*map(jnp.asarray, args))
    got = tmotion.motion_target(*map(torch.from_numpy, args))
    names = ("cls_target", "cls_weight", "best_reg", "reg_target", "reg_weight", "num_pos")
    for name, a, b in zip(names, got, ref):
        _close(a, b, f"motion_target {name}")


@pytest.mark.parametrize("cmd", [1, 3])
def test_plan_targets(case, cmd):
    """With one command and with three (the command slice)."""
    cfg, outputs, data = case
    rng = np.random.default_rng(8 + cmd)
    mode, ts = cfg.ego_fut_mode, cfg.ego_fut_ts
    cls = rng.standard_normal((BS, 1, cmd * mode)).astype(np.float32)
    reg = rng.standard_normal((BS, 1, cmd * mode, ts, 2)).astype(np.float32)
    gt = rng.standard_normal((BS, ts, 2)).astype(np.float32)
    gm = (rng.uniform(size=(BS, ts)) < 0.8).astype(np.float32)
    onehot = np.eye(max(cmd, 2), dtype=np.float32)[rng.integers(0, cmd, BS)][:, :cmd]
    args = (cls, reg, gt, gm, onehot)
    ref = jplan.sparse_plan_target(*map(jnp.asarray, args), cmd, ts)
    got = tplan.sparse_plan_target(*map(torch.from_numpy, args), cmd, ts)
    for i, (a, b) in enumerate(zip(got, ref)):
        _close(a, b, f"sparse_plan_target[{i}]")
    ref_t = np.asarray(ref[1])
    ref = jplan.align_plan_target(*map(jnp.asarray, args), jnp.asarray(ref_t), cmd, ts)
    got = tplan.align_plan_target(*map(torch.from_numpy, args), torch.from_numpy(ref_t).long(),
                                  cmd, ts)
    for i, (a, b) in enumerate(zip(got, ref)):
        _close(a, b, f"align_plan_target[{i}]")


def test_every_loss_of_compute_losses(case):
    """Every loss scalar of ``compute_losses`` from the same outputs and GT,
    the layer-batched Hungarian included."""
    cfg, outputs, data = case
    ref = jax.jit(lambda o, d: jloss.compute_losses(cfg, o, d))(
        _tree(outputs, jnp.asarray), _tree(data, jnp.asarray))
    got = tloss.compute_losses(cfg, _tree(outputs, torch.from_numpy),
                               _tree(data, torch.from_numpy))
    assert set(got) == set(ref), set(got) ^ set(ref)
    assert float(ref["det_loss_box"]) > 0  # some queries pass the threshold
    for k in sorted(ref):
        _close(got[k], ref[k], k)
    _close(tloss.total_loss(got), jloss.total_loss(ref), "total_loss")


def test_dense_depth_loss():
    rng = np.random.default_rng(9)
    preds = [np.exp(rng.standard_normal((BS, 2, h, w, 1))).astype(np.float32) * 20
             for h, w in ((8, 12), (4, 6))]
    preds[0][0, 0, 0, :3, 0] = (np.nan, np.inf, 80.0)
    gts = [np.where(rng.uniform(size=p.shape) < 0.5, rng.uniform(0, 60, p.shape), -1.0)
           .astype(np.float32) for p in preds]
    ref = jdepth.dense_depth_loss([jnp.asarray(p) for p in preds], [jnp.asarray(g) for g in gts])
    got = tdepth.dense_depth_loss([torch.from_numpy(p) for p in preds],
                                  [torch.from_numpy(g) for g in gts])
    _close(got, ref, "dense_depth_loss")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_grid_mask_given_the_same_scalars(seed):
    """The port's pure GridMask equals JAX's given the four scalars JAX
    draws from its key (reproduced here as ``grid_mask`` draws them)."""
    images = np.random.default_rng(seed).standard_normal((1, 2, 40, 56, 3)).astype(np.float32)
    h = images.shape[-3]
    rng = jax.random.PRNGKey(seed)
    k_apply, k_d, k_sh, k_sw = jax.random.split(rng, 4)
    d = int(jax.random.randint(k_d, (), 2, h))
    st_h = int(jax.random.randint(k_sh, (), 0, d))
    st_w = int(jax.random.randint(k_sw, (), 0, d))
    apply = bool(jax.random.uniform(k_apply, ()) < 0.7)
    ref = jgrid.grid_mask(rng, jnp.asarray(images))
    got = tgrid.grid_mask(torch.from_numpy(images), d, st_h, st_w, apply)
    _equal(got, ref, f"grid_mask seed {seed} (apply={apply})")


def test_grid_mask_draws_are_in_range():
    g = torch.Generator().manual_seed(0)
    draws = [tgrid.draw_grid_mask(g, 40) for _ in range(200)]
    assert all(2 <= d < 40 and 0 <= sh < d and 0 <= sw < d for d, sh, sw, _ in draws)
    assert 0.5 < np.mean([a for *_, a in draws]) < 0.9


def test_batchnorm_train_mode_matches_flax():
    """Outputs and the updated running statistics (biased variance,
    momentum 0.9) against flax ``nn.BatchNorm(use_running_average=False)``."""
    rng = np.random.default_rng(10)
    x = (rng.standard_normal((4, 7, 5, 16)) * 3 + 1).astype(np.float32)  # NHWC
    scale, bias = rng.uniform(0.5, 1.5, 16).astype(np.float32), rng.standard_normal(16).astype(np.float32)
    mean0, var0 = rng.standard_normal(16).astype(np.float32), rng.uniform(0.5, 2, 16).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}
    ref, mutated = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    tbn = BatchNorm(16).train()
    with torch.no_grad():
        for name, v in (("weight", scale), ("bias", bias), ("running_mean", mean0),
                        ("running_var", var0)):
            getattr(tbn, name).copy_(torch.from_numpy(v))
    got = tbn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, ref, "batchnorm output")
    _close(tbn.running_mean, mutated["batch_stats"]["mean"], "running_mean")
    _close(tbn.running_var, mutated["batch_stats"]["var"], "running_var")


def test_lr_schedule_matches_optax():
    ref = jopt.lr_schedule()
    for step in (0, 1, 250, 499, 500, 501, 40000, 88037, 88038, 90000):
        _close(lr_at(step), ref(step), f"lr at step {step}", rtol=1e-6, atol=0.0)


def test_adamw_update_matches_optax_given_the_same_gradients():
    """Three updates of a backbone leaf and a head leaf, the second with a
    gradient norm above the clip, one leaf without a gradient (zero in
    optax): parameters and the global norm against ``make_optimizer``."""
    rng = np.random.default_rng(11)
    p0 = {"backbone": {"w": rng.standard_normal((6, 5)).astype(np.float32)},
          "decoder": {"b": rng.standard_normal(7).astype(np.float32),
                      "z": rng.standard_normal(3).astype(np.float32)}}
    tx = jopt.make_optimizer()
    params = jax.tree_util.tree_map(jnp.asarray, p0)
    state = tx.init(params)
    tparams = {"backbone.w": torch.nn.Parameter(torch.from_numpy(p0["backbone"]["w"].copy())),
               "decoder.b": torch.nn.Parameter(torch.from_numpy(p0["decoder"]["b"].copy())),
               "decoder.z": torch.nn.Parameter(torch.from_numpy(p0["decoder"]["z"].copy()))}
    opt = AdamW(tparams.items())
    for i, scale in enumerate((1.0, 30.0, 1e-3)):
        g = {"backbone": {"w": (rng.standard_normal((6, 5)) * scale).astype(np.float32)},
             "decoder": {"b": (rng.standard_normal(7) * scale).astype(np.float32),
                         "z": np.zeros(3, np.float32)}}
        g["backbone"]["w"][0, 0] = 1e-9  # near zero: lr * sign(g) in the first update
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, updates)
        tparams["backbone.w"].grad = torch.from_numpy(g["backbone"]["w"])
        tparams["decoder.b"].grad = torch.from_numpy(g["decoder"]["b"])
        tparams["decoder.z"].grad = None
        norm = opt.step()
        _close(norm, optax.global_norm(g), f"step {i} grad norm", rtol=1e-6)
        for name, p in tparams.items():
            mod, leaf = name.split(".")
            _close(p, params[mod][leaf], f"step {i} {name}", rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("name", ["l1_loss", "smooth_l1_loss", "bce_with_logits",
                                  "binary_focal_loss", "gaussian_focal_loss",
                                  "sigmoid_focal_loss"])
@pytest.mark.parametrize("avg", [False, True])
def test_elementary_losses_match_jax(name, avg):
    """Each weighted loss of ``losses/common.py``, with a weight and with or
    without an ``avg_factor``."""
    from hipad_tpu.losses import common as jc
    from hipad_torch.losses import common as tc

    rng = np.random.default_rng(12)
    pred = rng.standard_normal((7, 5)).astype(np.float32) * 3
    weight = rng.uniform(0, 1, (7, 5)).astype(np.float32)
    kw = {"avg_factor": 4.0} if avg else {}
    if name == "sigmoid_focal_loss":
        target = rng.integers(0, 6, 7).astype(np.int32)  # 5 = background
        args, weight = (pred, target, 5), weight[:, 0]
    elif name == "gaussian_focal_loss":
        args = (1.0 / (1.0 + np.exp(-pred)), (rng.uniform(size=(7, 5)) < 0.3).astype(np.float32))
    elif name in ("binary_focal_loss", "bce_with_logits"):
        args = (pred, (rng.uniform(size=(7, 5)) < 0.3).astype(np.float32))
    else:
        args = (pred, rng.standard_normal((7, 5)).astype(np.float32))
    ref = getattr(jc, name)(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args),
                            weight=jnp.asarray(weight), loss_weight=0.7, **kw)
    got = getattr(tc, name)(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                              for a in args),
                            weight=torch.from_numpy(weight), loss_weight=0.7, **kw)
    _close(got, ref, name)
