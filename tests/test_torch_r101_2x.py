"""``stage2_r101_2x`` (ResNet-101, stage blocks 3-4-23-3, at 704x1280) in
the port, on the CPU at small sizes:

* the port against the benchmark's plain reference (``bench_h100/reference``)
  at an R101-shaped ``tiny()``, three streamed frames with banks carried,
  decoded outputs and the det bank exactly;
* the one stage-2 augmentation at a model's input size
  (``configs.model.aug_conf_for``), which the agent, the eval CLI and the
  benchmark's frames share;
* a default ``AgentCore`` feeding its model images, a projection and
  ``image_wh`` at the configuration's own input size, its plan the frame
  path's on the same inputs;
* the backbone's spans, one each a frame under ``backbone``.
"""

import os
import types

import numpy as np
import pytest
import torch

from hipad_torch import postprocess
from hipad_torch.agent.calib import stacked_lidar2img
from hipad_torch.agent.core import AgentCore
from hipad_torch.agent.replay import FakeSim
from hipad_torch.configs import model as configs
from hipad_torch.data import pipelines as pp
from hipad_torch.data import synthetic
from hipad_torch.models.common import to_float32
from hipad_torch.models.detector import HiPAD, batch_to_torch
from hipad_torch.utils import spans
from hipad_torch.weights import init_random

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

R101 = dict(num_cams=6, backbone_stage_blocks=(3, 4, 23, 3), input_size=(128, 192))
BACKBONE_SPANS = ["backbone.stem", "backbone.layer1", "backbone.layer2", "backbone.layer3",
                  "backbone.layer4", "backbone.fpn"]


def test_factory_is_resnet101_at_twice_stage2s_crop():
    cfg, base = configs.stage2_r101_2x(), configs.stage2()
    assert cfg.backbone_stage_blocks == (3, 4, 23, 3) and cfg.backbone_base_planes == 64
    assert cfg.input_size == (704, 1280) == tuple(2 * s for s in base.input_size)


def test_port_equals_the_plain_reference_at_an_r101_tiny():
    from bench_h100.harness import spec, traffic
    from bench_h100.harness.cells import reference_banks
    from bench_h100.harness.weights import make_weights
    from bench_h100.reference.hipad import postprocess as ref_post
    from bench_h100.reference.hipad.configs import model as ref_configs
    from bench_h100.reference.hipad.models.detector import HiPAD as RefHiPAD

    cfg, ref_cfg = configs.tiny(**R101), ref_configs.tiny(**R101)
    ref = RefHiPAD(ref_cfg, device="cpu").eval()
    sd = make_weights(ref, ref_cfg, 2 ** 31 + 101, "cpu")
    ref.load_state_dict(sd)
    prog = HiPAD(cfg, device="cpu")
    prog.load_state_dict(sd)
    p = spec.load_json(spec.HERE / "traffic" / "stream_frames.json")
    p["cameras"].update(pool=2, shapes=5)
    gen = traffic.StreamFrames(p, cfg, 11, "cpu")
    banks_p = None
    with torch.no_grad():
        for i in range(3):
            images, metas_np = gen.frame(i)
            assert images.shape == (1, 6, 128, 192, 3)
            metas = {k: torch.from_numpy(v) for k, v in metas_np.items()}
            out_r, banks_r = ref(images, metas, reference_banks(banks_p))
            out_p, banks_p = prog(images, metas, banks_p)
            dec_p = postprocess.post_process_arrays(cfg, out_p, metas["gt_ego_fut_cmd"])
            dec_r = ref_post.post_process_arrays(ref_cfg, out_r, metas["gt_ego_fut_cmd"])
            assert dec_p.keys() == dec_r.keys()
            for k in dec_p:
                torch.testing.assert_close(dec_p[k], dec_r[k], rtol=0, atol=0)
            torch.testing.assert_close(banks_p.det.feature, banks_r.det.feature, rtol=0, atol=0)


@pytest.mark.parametrize("size, resize, crop", [
    ((352, 640), 0.4, (0, 8, 640, 360)),
    ((704, 1280), 0.8, (0, 16, 1280, 720)),
    ((128, 192), 128 / 900, (17, 0, 209, 128)),
])
def test_aug_conf_for_gives_the_test_time_crop(size, resize, crop):
    from bench_h100.harness.traffic import rig_aug

    conf = configs.aug_conf_for(size)
    if size == pp.DATA_AUG_CONF["final_dim"]:
        assert conf is pp.DATA_AUG_CONF
    assert conf["final_dim"] == size
    aug = pp.sample_aug_config(conf, test_mode=True)
    assert aug["resize"] == pytest.approx(resize, rel=1e-12) and aug["crop"] == crop
    assert (aug["flip"], aug["rotate"]) == (False, 0.0)
    # the benchmark's frames take the same resize and crop
    assert rig_aug(types.SimpleNamespace(input_size=size)) == aug
    # the training draw's resized image still covers the crop
    lo = conf["resize_lim"][0]
    assert int(pp.DATA_AUG_CONF["W"] * lo) >= size[1] and int(pp.DATA_AUG_CONF["H"] * lo) >= size[0]


def test_default_agent_follows_the_configs_input_size():
    cfg = configs.tiny(num_cams=6, input_size=(128, 192))
    agent = AgentCore(cfg, init_random(HiPAD(cfg, device="cpu"), 5).state_dict(),
                      dtype=torch.float32, jpeg_quality=None, n_banks=1, device="cpu")
    aug = pp.sample_aug_config(configs.aug_conf_for((128, 192)), test_mode=True)
    assert agent.aug == aug
    seen = []
    forward = agent._forward

    def kept(images_u8, metas, banks):
        decoded, new = forward(images_u8, metas, banks)
        seen.append((images_u8, metas, banks, decoded))
        return decoded, new

    agent._forward = kept
    sim = FakeSim(seed=3)
    for _ in range(2):
        agent.run_step(sim.observe())
    for images_u8, metas, banks, decoded in seen:
        assert images_u8.shape == (1, 6, 128, 192, 3) and images_u8.dtype == torch.uint8
        want = (pp.img_transform_matrix(aug)[None] @ stacked_lidar2img()).astype(np.float32)
        assert np.array_equal(metas["projection_mat"][0].numpy(), want)
        assert np.array_equal(metas["image_wh"][0].numpy(), np.tile([192.0, 128.0], (6, 1)))
        # the frame path on the agent's own inputs gives the agent's plan
        images = (images_u8.float() - agent.mean) / agent.std
        with torch.no_grad():
            out, _ = agent.model(images, metas, banks)
            dec = postprocess.post_process_arrays(cfg, to_float32(out), metas["gt_ego_fut_cmd"],
                                                  agent.with_rescore)
        for k in dec:
            assert torch.equal(dec[k], decoded[k]), k
    assert seen[1][2] is not None  # the second tick ran from the first's banks


def test_frame_opens_the_backbone_spans_in_order():
    cfg = configs.tiny()
    model = init_random(HiPAD(cfg, device="cpu"), 0)
    images, metas = batch_to_torch(synthetic.make_batch(cfg, 1), "cpu")
    with torch.no_grad(), spans.recording() as rec:
        model(images, metas)
    bb = rec.name.index("backbone")
    kids = [rec.name[i] for i, p in enumerate(rec.parent) if p == bb]
    assert kids == BACKBONE_SPANS
    assert all(rec.name.count(n) == 1 for n in BACKBONE_SPANS)
    assert rec.name[rec.parent[bb]] == "forward"
    firsts = [rec.name.index(n) for n in BACKBONE_SPANS]
    assert all(rec.start_ns[a] <= rec.end_ns[a] <= rec.start_ns[b]
               for a, b in zip(firsts, firsts[1:]))
