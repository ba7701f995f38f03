"""The port's weight converter and k-means tool against the JAX package's
tools on the CPU: the reference-style fake state dicts that
``tests/test_convert_weights.py`` builds, converted by both; the port's
converter loading them into ``HiPAD`` and writing a work dir that the
port's checkpoint loader reads; and k-means on seeded points. (Their
copied functions are held to the tools' in ``test_torch_port_copies.py``.)"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))

import convert_weights as jcw  # noqa: E402
import kmeans as jkm  # noqa: E402
from test_convert_weights import _fake_mmdet_backbone_sd, _fake_stage2_decoder_sd  # noqa: E402

from hipad_torch.configs.model import stage2, tiny  # noqa: E402
from hipad_torch.models.detector import HiPAD, batch_to_torch  # noqa: E402
from hipad_torch.data import synthetic  # noqa: E402
from hipad_torch.tools import convert_weights as tcw  # noqa: E402
from hipad_torch.tools import kmeans as tkm  # noqa: E402
from hipad_torch.train import checkpoint  # noqa: E402
from hipad_torch.weights import from_jax, init_random  # noqa: E402

def _converted(tool, sd, **kw):
    params, stats, leftovers = tool.convert(dict(sd), **kw)
    return from_jax({"params": params, "batch_stats": stats}), leftovers


@pytest.mark.parametrize("which", ["backbone", "decoder"])
def test_port_state_dict_equals_from_jax_of_the_tools_tree(which):
    """The fake backbone (tiny()'s ResNet and FPN widths) and the fake
    stage-2 decoder: the port's converted state dict equals ``from_jax`` of
    the JAX tool's tree, and the model takes every converted tensor."""
    if which == "backbone":
        sd, kw, cfg = _fake_mmdet_backbone_sd(), dict(stage_blocks=(1, 1, 1, 1)), tiny()
    else:
        sd, kw, cfg = _fake_stage2_decoder_sd(), {}, stage2()
    got, left = _converted(tcw, sd, **kw)
    ref, ref_left = _converted(jcw, sd, **kw)
    assert left == ref_left == []
    assert list(got) == list(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    model = HiPAD(cfg, device="cpu")
    applied_p, applied_s, leftovers, unused = tcw.convert_into(model, sd, **kw)
    assert unused == [] and leftovers == []
    assert len(applied_p) + len(applied_s) == len(ref)
    own = model.state_dict()
    for k, v in ref.items():
        assert torch.equal(own[k], v), k


def test_main_writes_a_work_dir_the_port_loads(tmp_path, monkeypatch):
    """``main``: the ``.pth`` (a ``{"state_dict": ...}`` of tensors) ->
    step 0 of a work dir; ``load_params_only`` puts the converted backbone
    into a fresh model, whose forward then differs from its own init."""
    sd = _fake_mmdet_backbone_sd()
    pth = tmp_path / "ref.pth"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, pth)
    monkeypatch.setattr(tcw, "convert", lambda s, **kw: jcw.convert(s, stage_blocks=(1, 1, 1, 1)))
    import hipad_torch.configs.model as cfgs

    monkeypatch.setattr(cfgs, "stage2", tiny)
    res = tcw.main(["--torch-ckpt", str(pth), "--out", str(tmp_path / "work"), "--report"])
    assert res["leftovers"] == [] and res["unused"] == []
    assert checkpoint.latest_step(str(tmp_path / "work")) == 0
    cfg = tiny()
    model = init_random(HiPAD(cfg, device="cpu"), 3)
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    assert checkpoint.load_params_only(str(tmp_path / "work"), model) == []
    ref, _ = _converted(jcw, sd, stage_blocks=(1, 1, 1, 1))
    for k, v in ref.items():
        assert torch.equal(model.state_dict()[k], v), k
    images, metas = batch_to_torch(synthetic.make_batch(cfg, 1), "cpu")
    model.eval()
    with torch.no_grad():
        feats = model.backbone(images)
        model.load_state_dict(fresh)
        feats0 = model.backbone(images)
    assert all(torch.isfinite(f).all() for f in feats)
    assert not torch.equal(feats[0], feats0[0])


def test_merge_into_reports_mismatches_and_leftovers():
    target = {"a": {"w": np.zeros((2, 3), np.float32)}, "b": np.zeros(4, np.float32)}
    merged, applied, unused = tcw.merge_into(target, {"a": {"w": np.ones((2, 3))},
                                                      "c": np.ones(1)})
    assert applied == [("a", "w")] and unused == [("c",)]
    assert merged["a"]["w"].dtype == np.float32 and (merged["a"]["w"] == 1).all()
    assert (target["a"]["w"] == 0).all()
    with pytest.raises(ValueError, match="shape"):
        tcw.merge_into(target, {"b": np.ones(5)})


def test_kmeans_equals_the_tools():
    rng = np.random.RandomState(0)
    pts = np.concatenate([rng.randn(200, 3) + c for c in ((0, 0, 0), (8, 0, 0), (0, 8, 2))])
    np.testing.assert_array_equal(tkm.kmeans(pts.copy(), 5, iters=20),
                                  jkm.kmeans(pts.copy(), 5, iters=20))
    np.testing.assert_array_equal(tkm.kmeans(pts[:3].copy(), 5), jkm.kmeans(pts[:3].copy(), 5))
    anchors = rng.uniform(0, 5, (4, 6, 2)).astype(np.float32)
    np.testing.assert_array_equal(tkm.resample_spacing(anchors, 5.0, 2.0),
                                  jkm.resample_spacing(anchors, 5.0, 2.0))
