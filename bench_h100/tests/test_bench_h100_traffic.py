"""Each traffic generator repeats from its seed and differs across seeds,
at the same sizes."""

import numpy as np
import torch

from bench_h100.harness import spec, traffic

SEEDS = (2 ** 31 + 5, 2 ** 31 + 6)


def _frames(seed):
    from hipad_torch.configs import model as configs

    p = spec.load_json(spec.HERE / "traffic" / "stream_frames.json")
    p["cameras"].update(pool=2, shapes=5)
    gen = traffic.StreamFrames(p, configs.tiny(num_cams=6, input_size=(64, 96)), seed, "cpu")
    return [gen.frame(i) for i in range(5)]


def test_camera_frames_repeat_and_differ():
    def make(seed):
        return traffic.camera_frames(3, 45, 80, 6, 2.0, traffic.generator(seed, "cpu"), "cpu")

    a, b, c = make(SEEDS[0]), make(SEEDS[0]), make(SEEDS[1])
    assert a.dtype == torch.uint8 and a.shape == (3, 45, 80, 3)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_stream_frames_repeat_and_differ():
    a, b, c = _frames(SEEDS[0]), _frames(SEEDS[0]), _frames(SEEDS[1])
    for (ia, ma), (ib, mb) in zip(a, b):
        assert torch.equal(ia, ib) and all(np.array_equal(ma[k], mb[k]) for k in ma)
    assert not torch.equal(a[0][0], c[0][0])
    assert not np.array_equal(a[0][1]["T_global"], c[0][1]["T_global"])
    assert [m["timestamp"][0] for _, m in a] == [0.0, 0.5, 1.0, 1.5, 2.0]
    assert a[0][0].shape == c[0][0].shape == (1, 6, 64, 96, 3)
