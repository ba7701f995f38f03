"""A released reference checkpoint (``hipad_stage2.pth``, mmdet-style) ->
a work dir of the port's checkpoints (counterpart of
``tools/convert_weights.py``).

The numpy rules that map the reference's ``state_dict`` onto the JAX
package's parameter tree are that tool's, copied verbatim
(``conv_w`` through ``convert``); the port then takes the tree through
``weights.from_jax``, as every flax tree reaches it:

  * Conv2d weight [O, I, kh, kw] -> flax [kh, kw, I, O] -> Conv2d again;
  * Linear weight [O, I] -> flax kernel [I, O] -> Linear again;
  * BatchNorm weight/bias/running_mean/running_var -> scale/bias and
    batch_stats mean/var -> the BatchNorm's own names.

``main`` loads the ``.pth``, converts it, merges the converted leaves into
``HiPAD(cfg)``'s seeded initialisation (``merge_into``, a numpy version of
the tool's, over the port's parameters as a flax-shaped tree) and writes step
0 of a work dir that ``train.checkpoint.load_params_only`` reads: the eval
CLI's ``--ckpt``, the CARLA agent and the error sweep's ``--load-from``
take it. It prints how many tensors were applied and, with ``--report``,
the reference keys left unmapped.

    python -m hipad_torch.tools.convert_weights --torch-ckpt hipad_stage2.pth \
        --out work_dirs/converted [--stage 2] [--report]
"""

from __future__ import annotations

import argparse
import copy
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


def conv_w(t: np.ndarray) -> np.ndarray:
    return np.transpose(t, (2, 3, 1, 0))


def linear_w(t: np.ndarray) -> np.ndarray:
    return np.transpose(t, (1, 0))


def _bn(dst_params, dst_stats, prefix_parts, sd, src):
    """Route a torch BN into flax params (scale/bias) + batch_stats."""
    _set(dst_params, prefix_parts + ("scale",), sd[src + ".weight"])
    _set(dst_params, prefix_parts + ("bias",), sd[src + ".bias"])
    _set(dst_stats, prefix_parts + ("mean",), sd[src + ".running_mean"])
    _set(dst_stats, prefix_parts + ("var",), sd[src + ".running_var"])
    for suffix in (".weight", ".bias", ".running_mean", ".running_var",
                   ".num_batches_tracked"):
        sd.pop(src + suffix, None)


def _set(tree: Dict, path: Tuple[str, ...], value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = np.asarray(value)


def convert_backbone(sd: Dict[str, np.ndarray], params: Dict, stats: Dict,
                     stage_blocks=(3, 4, 6, 3)):
    """torchvision-ResNet50 + mmdet-FPN names -> our ResNetFPN tree."""
    root = ("backbone", "resnet")
    if "img_backbone.conv1.weight" in sd:
        _set(params, root + ("stem_conv", "kernel"),
             conv_w(sd.pop("img_backbone.conv1.weight")))
        _bn(params, stats, root + ("stem_bn",), sd, "img_backbone.bn1")
    for stage, nblocks in enumerate(stage_blocks):
        for b in range(nblocks):
            src = f"img_backbone.layer{stage+1}.{b}"
            dst = root + (f"layer{stage+1}_block{b}",)
            for ci in (1, 2, 3):
                key = f"{src}.conv{ci}.weight"
                if key in sd:
                    _set(params, dst + (f"conv{ci}", "kernel"), conv_w(sd.pop(key)))
                    _bn(params, stats, dst + (f"bn{ci}",), sd, f"{src}.bn{ci}")
            key = f"{src}.downsample.0.weight"
            if key in sd:
                _set(params, dst + ("downsample_conv", "kernel"), conv_w(sd.pop(key)))
                _bn(params, stats, dst + ("downsample_bn",), sd, f"{src}.downsample.1")
    # FPN (mmdet: lateral_convs.{i}.conv + fpn_convs.{i}.conv[+bn])
    for i in range(4):
        k = f"img_neck.lateral_convs.{i}.conv"
        if k + ".weight" in sd:
            _set(params, ("backbone", "fpn", f"lateral_{i}", "kernel"),
                 conv_w(sd.pop(k + ".weight")))
            if k + ".bias" in sd:
                _set(params, ("backbone", "fpn", f"lateral_{i}", "bias"),
                     sd.pop(k + ".bias"))
        k = f"img_neck.fpn_convs.{i}.conv"
        if k + ".weight" in sd:
            _set(params, ("backbone", "fpn", f"fpn_conv_{i}", "kernel"),
                 conv_w(sd.pop(k + ".weight")))
            if k + ".bias" in sd:
                _set(params, ("backbone", "fpn", f"fpn_conv_{i}", "bias"),
                     sd.pop(k + ".bias"))
        for bn_src in (f"img_neck.fpn_convs.{i}.bn", f"img_neck.fpn_convs.{i}.norm"):
            if bn_src + ".weight" in sd:
                _bn(params, stats, ("backbone", "fpn", f"fpn_bn_{i}"), sd, bn_src)
    # depth branch: 1x1 convs (`models/blocks.py:285-289`)
    for i in range(3):
        k = f"depth_branch.depth_layers.{i}"
        if k + ".weight" in sd:
            _set(params, ("depth_net", f"depth_conv_{i}", "kernel"),
                 conv_w(sd.pop(k + ".weight")))
            _set(params, ("depth_net", f"depth_conv_{i}", "bias"), sd.pop(k + ".bias"))


HEAD = "head.onedecoder_head."

# Stage-2 operation program (`hipad_b2d_stage2.py:70-74`).
SINGLE_LAYER = ("concat", "gnn", "inter_gnn", "norm", "split",
                "deformable", "concat", "ffn", "norm", "split", "refine")
TEMPORAL_LAYER = ("concat", "temp_gnn", "gnn", "inter_gnn", "norm", "split",
                  "deformable", "concat", "ffn", "norm", "split", "refine")
STAGE2_OPS = SINGLE_LAYER + TEMPORAL_LAYER * 5

GNN_GROUPS = {"gnn": 2, "temp_gnn": 3, "inter_gnn": 1}  # config:225-292


def _lin(params, dst, sd, src):
    if src + ".weight" in sd:
        _set(params, dst + ("kernel",), linear_w(sd.pop(src + ".weight")))
        if src + ".bias" in sd:
            _set(params, dst + ("bias",), sd.pop(src + ".bias"))


def _ln(params, dst, sd, src):
    if src + ".weight" in sd:
        _set(params, dst + ("scale",), sd.pop(src + ".weight"))
        _set(params, dst + ("bias",), sd.pop(src + ".bias"))


def _mlpln(params, dst, sd, src, in_loops, out_loops):
    """torch Sequential(linear_relu_ln(...)) -> our MLPLN naming."""
    i = 0
    for o in range(out_loops):
        for k in range(in_loops):
            _lin(params, dst + (f"fc_{o}_{k}",), sd, f"{src}.{i}")
            i += 2  # Linear, ReLU
        _ln(params, dst + (f"ln_{o}",), sd, f"{src}.{i}")
        i += 1
    return i  # next sequential index


def _mha(params, dst, sd, src):
    """FlashMHA packed qkv (`attention.py:116-123`) -> q/k/v/out projections."""
    wkey = src + ".in_proj_weight"
    if wkey not in sd:
        return
    w = sd.pop(wkey)
    d = w.shape[0] // 3
    for name, chunk in zip(("q_proj", "k_proj", "v_proj"),
                           (w[:d], w[d : 2 * d], w[2 * d :])):
        _set(params, dst + (name, "kernel"), linear_w(chunk))
    bkey = src + ".in_proj_bias"
    if bkey in sd:
        b = sd.pop(bkey)
        for name, chunk in zip(("q_proj", "k_proj", "v_proj"),
                               (b[:d], b[d : 2 * d], b[2 * d :])):
            _set(params, dst + (name, "bias"), chunk)
    _lin(params, dst + ("out_proj",), sd, src + ".out_proj")


def _conv_bn_encoder(params, stats, dst, sd, src):
    """Front-view conv-BN-conv-BN encoder (`ego/instance_bank.py:68-75`)."""
    if src + ".0.weight" not in sd:
        return
    _set(params, dst + ("conv1", "kernel"), conv_w(sd.pop(src + ".0.weight")))
    _bn(params, stats, dst + ("bn1",), sd, src + ".1")
    _set(params, dst + ("conv2", "kernel"), conv_w(sd.pop(src + ".2.weight")))
    _bn(params, stats, dst + ("bn2",), sd, src + ".3")


def _refine_reg_cls(params, sd, src, dst, with_quality=False):
    """`layers`/`cls_layers`(/`quality_layers`) refinement stacks
    (`det/blocks.py:96-120`, `map/blocks.py:101-112`)."""
    nxt = _mlpln(params, dst + ("reg_mlp",), sd, src + ".layers", 2, 2)
    _lin(params, dst + ("reg_out",), sd, f"{src}.layers.{nxt}")
    skey = f"{src}.layers.{nxt + 1}.scale"
    if skey in sd:
        _set(params, dst + ("reg_scale", "scale"), sd.pop(skey))
    _mlpln(params, dst + ("cls", "mlp"), sd, src + ".cls_layers", 1, 2)
    _lin(params, dst + ("cls", "out"), sd, src + ".cls_layers.6")
    if with_quality:
        _mlpln(params, dst + ("quality_mlp",), sd, src + ".quality_layers", 1, 2)
        _lin(params, dst + ("quality_out",), sd, src + ".quality_layers.6")


def convert_decoder(sd: Dict[str, np.ndarray], params: Dict, stats: Dict,
                    operation_order=STAGE2_OPS,
                    plan_anchor_types=None):
    """Full unified-decoder mapping (reference module tree from
    `sparse_onedecoder.py:203-365` -> our `models/decoder.py` naming)."""
    D = ("decoder",)
    plan_anchor_types = plan_anchor_types or (
        ("temp", "5hz"), ("spat", "2m"), ("temp", "2hz"), ("spat", "5m"),
        ("speed", "5hz"), ("speed", "5hz"), ("speed", "5hz"),
        ("speed", "2hz"), ("speed", "2hz"), ("speed", "2hz"),
    )

    # anchors / bank parameters
    for src, dst in {
        "det_instance_bank.anchor": "det_anchor",
        "det_instance_bank.instance_feature": "det_feature",
        "map_instance_bank.anchor": "map_anchor",
        "map_instance_bank.instance_feature": "map_feature",
        "plan_instance_bank.plan_anchor": "plan_anchor",
    }.items():
        if HEAD + src in sd:
            _set(params, D + (dst,), sd.pop(HEAD + src))

    # decoupled-attention lift/squeeze (`sparse_onedecoder.py:354-359`)
    _lin(params, D + ("fc_before",), sd, HEAD + "fc_before")
    _lin(params, D + ("fc_after",), sd, HEAD + "fc_after")

    # anchor encoders
    for fc in ("pos_fc", "size_fc", "yaw_fc", "vel_fc"):
        _mlpln(params, D + ("det_anchor_encoder", fc), sd,
               HEAD + f"det_anchor_encoder.{fc}", 1, 4)
    _mlpln(params, D + ("map_anchor_encoder", "pos_fc"), sd,
           HEAD + "map_anchor_encoder.pos_fc", 1, 2)
    _mlpln(params, D + ("plan_anchor_encoder", "pos_fc"), sd,
           HEAD + "plan_anchor_encoder.pos_fc", 1, 2)

    # plan/ego auxiliary encoders
    _mlpln(params, D + ("target_point_encoder_mlp",), sd,
           HEAD + "target_point_encoder", 2, 1)
    _lin(params, D + ("target_point_encoder_out",), sd,
         HEAD + "target_point_encoder.5")
    _mlpln(params, D + ("command_encoder_mlp",), sd,
           HEAD + "command_embed_encoder", 2, 1)
    _lin(params, D + ("command_encoder_out",), sd,
         HEAD + "command_embed_encoder.5")
    _mlpln(params, D + ("motion_anchor_encoder_mlp",), sd,
           HEAD + "motion_anchor_encoder", 1, 1)
    _lin(params, D + ("motion_anchor_encoder_out",), sd,
         HEAD + "motion_anchor_encoder.3")
    if HEAD + "motion_anchor" in sd:
        sd.pop(HEAD + "motion_anchor")  # constant, loaded from data/kmeans

    # front-view feature encoders (banks)
    _conv_bn_encoder(params, stats, D + ("ego_feature_encoder",), sd,
                     HEAD + "ego_instance_bank.ego_feature_encoder")
    _conv_bn_encoder(params, stats, D + ("plan_feature_encoder",), sd,
                     HEAD + "plan_instance_bank.plan_feature_encoder")

    # operation-program layers (names indexed by position in the program)
    for i, op in enumerate(operation_order):
        src = HEAD + f"layers.{i}"
        if op == "norm":
            _ln(params, D + (f"norm_{i}",), sd, src)
        elif op == "ffn":
            _ln(params, D + (f"ffn_{i}", "pre_norm"), sd, src + ".pre_norm")
            _lin(params, D + (f"ffn_{i}", "fc1"), sd, src + ".layers.0.0")
            _lin(params, D + (f"ffn_{i}", "fc2"), sd, src + ".layers.1")
            _lin(params, D + (f"ffn_{i}", "identity_fc"), sd, src + ".identity_fc")
        elif op in GNN_GROUPS:
            for g in range(GNN_GROUPS[op]):
                _mha(params, D + (f"{op}_{i}", f"attn_{g}"), sd,
                     src + f".attns.{g}.attn")

    # per-task deformables + refines (module-list index == occurrence index)
    n_deform = operation_order.count("deformable")
    n_refine = operation_order.count("refine")
    for task in ("det", "map", "plan", "ego"):
        for j in range(n_deform):
            src = HEAD + f"{task}_deformable.{j}"
            dst = D + (f"{task}_deformable_{j}",)
            _mlpln(params, dst + ("camera_encoder",), sd, src + ".camera_encoder", 1, 2)
            _lin(params, dst + ("weights_fc",), sd, src + ".weights_fc")
            _lin(params, dst + ("output_proj",), sd, src + ".output_proj")
            # keypoint generators live beside (not inside) the deformable
            # module in our tree: decoder/{task}_kps_{j}
            _lin(params, D + (f"{task}_kps_{j}", "learnable_fc"), sd,
                 src + ".kps_generator.learnable_fc")
    for j in range(n_refine):
        _refine_reg_cls(params, sd, HEAD + f"det_refine.{j}",
                        D + (f"det_refine_{j}",), with_quality=True)
        _refine_reg_cls(params, sd, HEAD + f"map_refine.{j}",
                        D + (f"map_refine_{j}",))
        # motion: cls (1,2)+Linear, reg = 3 plain Linears
        src = HEAD + f"motion_refine.{j}"
        dst = D + (f"motion_refine_{j}",)
        _mlpln(params, dst + ("cls", "mlp"), sd, src + ".motion_cls_branch", 1, 2)
        _lin(params, dst + ("cls", "out"), sd, src + ".motion_cls_branch.6")
        for k, seq in enumerate((0, 2, 4)):
            _lin(params, dst + ("reg", f"fc_{k}"), sd, src + f".motion_reg_branch.{seq}")
        # ego status: 3 plain Linears
        src = HEAD + f"ego_refine.{j}"
        dst = D + (f"ego_refine_{j}",)
        for k, seq in enumerate((0, 2, 4)):
            _lin(params, dst + ("status", f"fc_{k}"), sd, src + f".plan_status_branch.{seq}")
        # plan: shared cls (+speed cls) + per-anchor-type reg branches
        src = HEAD + f"plan_refine.{j}"
        dst = D + (f"plan_refine_{j}",)
        _mlpln(params, dst + ("cls", "mlp"), sd, src + ".plan_cls_branch", 1, 2)
        _lin(params, dst + ("cls", "out"), sd, src + ".plan_cls_branch.6")
        _mlpln(params, dst + ("cls_speed", "mlp"), sd, src + ".plan_cls_branch_speed", 1, 2)
        _lin(params, dst + ("cls_speed", "out"), sd, src + ".plan_cls_branch_speed.6")
        seen = set()
        for t in plan_anchor_types:
            key = f"{t[0]}_{t[1]}"
            if key in seen:
                continue
            seen.add(key)
            bsrc = src + f".plan_reg_branch_{key}"
            nxt = _mlpln(params, dst + (f"reg_{key}_mlp",), sd, bsrc, 2, 2)
            _lin(params, dst + (f"reg_{key}_out",), sd, f"{bsrc}.{nxt}")
            skey = f"{bsrc}.{nxt + 1}.scale"
            if skey in sd:
                _set(params, dst + (f"reg_{key}_scale", "scale"), sd.pop(skey))


def convert(sd: Dict[str, np.ndarray], stage_blocks=(3, 4, 6, 3),
            operation_order=STAGE2_OPS, plan_anchor_types=None):
    """-> (params, batch_stats, leftover_keys)."""
    sd = dict(sd)
    params: Dict = {}
    stats: Dict = {}
    convert_backbone(sd, params, stats, stage_blocks)
    convert_decoder(sd, params, stats, operation_order, plan_anchor_types)
    return params, stats, sorted(sd.keys())


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def merge_into(target: Dict, source: Dict, strict_shapes: bool = True):
    """Overwrite the leaves of ``target`` (a nested dict of arrays) that
    ``source`` holds at the same path and shape -> (merged, applied paths,
    source paths unused); raises on a shape mismatch with
    ``strict_shapes``. The numpy counterpart of the JAX tool's."""
    flat_src = _flatten(source)
    merged = copy.deepcopy(target)

    applied, mismatched = [], []

    def walk(node, path):
        for k in list(node.keys()):
            p = path + (k,)
            if isinstance(node[k], dict):
                walk(node[k], p)
            elif p in flat_src:
                if tuple(node[k].shape) == tuple(flat_src[p].shape):
                    node[k] = np.asarray(flat_src[p], dtype=np.float32)
                    applied.append(p)
                else:
                    mismatched.append((p, node[k].shape, flat_src[p].shape))

    walk(merged, ())
    unused = [p for p in flat_src if p not in set(applied)]
    if strict_shapes and mismatched:
        raise ValueError(f"shape mismatches: {mismatched[:5]}")
    return merged, applied, unused


def convert_into(model, sd: Dict[str, np.ndarray], **convert_kw):
    """Convert ``sd`` and load it over ``model``'s parameters and buffers ->
    (applied parameter paths, applied statistic paths, reference keys left
    unmapped, converted paths the model has no leaf for)."""
    from ..weights import from_jax, to_jax

    params, stats, leftovers = convert(sd, **convert_kw)
    tree = to_jax(model.state_dict())
    new_params, applied_p, unused_p = merge_into(tree["params"], params)
    new_stats, applied_s, unused_s = merge_into(tree.get("batch_stats", {}), stats)
    merged = from_jax({"params": new_params, "batch_stats": new_stats})
    model.load_state_dict(merged)
    return applied_p, applied_s, leftovers, unused_p + unused_s


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--torch-ckpt", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--stage", type=int, default=2)
    p.add_argument("--report", action="store_true")
    args = p.parse_args(argv)

    import torch

    from ..configs import model as cfgs
    from ..models.detector import HiPAD
    from ..train.checkpoint import save_checkpoint
    from ..train.optim import AdamW
    from ..weights import init_random

    ckpt = torch.load(args.torch_ckpt, map_location="cpu")
    sd = ckpt.get("state_dict", ckpt)
    sd = {k: v.numpy() for k, v in sd.items() if hasattr(v, "numpy")}
    cfg = cfgs.stage2() if args.stage == 2 else cfgs.stage1()
    model = init_random(HiPAD(cfg, device="cpu"), 0)
    applied_p, applied_s, leftovers, unused = convert_into(model, sd)
    save_checkpoint(args.out, 0, model, AdamW(model.named_parameters()))
    print(f"applied {len(applied_p)} param + {len(applied_s)} stat tensors -> {args.out}")
    if args.report:
        print(f"source keys left unmapped ({len(leftovers)}):")
        for k in leftovers[:50]:
            print("  ", k)
        if unused:
            print("converted-but-unmatched:", unused[:20])
    return {"applied_params": applied_p, "applied_stats": applied_s, "leftovers": leftovers,
            "unused": unused}


if __name__ == "__main__":
    main()
