"""The plain reference against the port at ``tiny()`` on the CPU."""

import torch

from bench_h100.harness import spec, traffic
from bench_h100.harness.cells import reference_banks
from bench_h100.harness.weights import make_weights


def test_reference_imports_nothing_of_the_program():
    import pathlib
    import re

    base = pathlib.Path(spec.HERE / "reference")
    for f in base.rglob("*.py"):
        src = f.read_text()
        assert not re.search(r"^\s*(from|import)\s+(hipad_torch|hipad_tpu|jax)\b", src, re.M), f


def test_reference_agrees_with_the_port_at_tiny():
    from hipad_torch import postprocess
    from hipad_torch.configs import model as configs
    from hipad_torch.models.detector import HiPAD

    from bench_h100.reference.hipad import postprocess as ref_post
    from bench_h100.reference.hipad.configs import model as ref_configs
    from bench_h100.reference.hipad.models.detector import HiPAD as RefHiPAD

    cfg = configs.tiny(num_cams=6, input_size=(64, 96))
    ref_cfg = ref_configs.tiny(num_cams=6, input_size=(64, 96))
    ref = RefHiPAD(ref_cfg, device="cpu").eval()
    sd = make_weights(ref, ref_cfg, 2 ** 31 + 3, "cpu")
    ref.load_state_dict(sd)
    prog = HiPAD(cfg, device="cpu")
    prog.load_state_dict(sd)
    p = spec.load_json(spec.HERE / "traffic" / "stream_frames.json")
    p["cameras"].update(pool=2, shapes=5)
    gen = traffic.StreamFrames(p, cfg, 7, "cpu")
    banks_p = None
    with torch.no_grad():
        for i in range(3):
            images, metas_np = gen.frame(i)
            metas = {k: torch.from_numpy(v) for k, v in metas_np.items()}
            out_r, banks_r = ref(images, metas, reference_banks(banks_p))
            out_p, banks_p = prog(images, metas, banks_p)
            dec_p = postprocess.post_process_arrays(cfg, out_p, metas["gt_ego_fut_cmd"])
            dec_r = ref_post.post_process_arrays(ref_cfg, out_r, metas["gt_ego_fut_cmd"])
            for k in dec_p:
                torch.testing.assert_close(dec_p[k], dec_r[k], rtol=0, atol=0)
            torch.testing.assert_close(banks_p.det.feature, banks_r.det.feature, rtol=0, atol=0)


def test_weights_repeat_from_the_seed_and_cover_the_model():
    from bench_h100.reference.hipad.configs import model as ref_configs
    from bench_h100.reference.hipad.models.detector import HiPAD as RefHiPAD

    cfg = ref_configs.tiny()
    with torch.device("meta"):
        skel = RefHiPAD(cfg, device="meta")
    a, b = make_weights(skel, cfg, 5, "cpu"), make_weights(skel, cfg, 5, "cpu")
    c = make_weights(skel, cfg, 6, "cpu")
    assert set(a) == set(skel.state_dict())
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)
