"""The model FLOPs of one frame of a configuration, counted by
``torch.utils.flop_counter.FlopCounterMode`` over the plain reference
(fp32, bs=1) on a warm frame (banks from the frame before), as the cells
stream them; recorded as ``model_flops_per_frame`` in the configuration's
file, which the ``mfu`` readers read.

The plain coarse sampler takes each level as a dense ``[M, H*W] x [H*W, C]``
product; the model's work there is 2 operations a channel a live tap
(``taps.coarse_sample_work``), so the dense product's count is taken out
and the taps' put in.

    python3 bench_h100/counts/flops.py <config> [<config> ...]
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))


def count(entry: dict, params: dict, device) -> dict:
    """FLOPs and seconds of the reference's cold and warm frame of the
    configuration ``entry`` on the frames of ``params``."""
    from torch.utils.flop_counter import FlopCounterMode

    from bench_h100.harness import traffic
    from bench_h100.harness.cells import Driver
    from bench_h100.harness.spec import Cell

    cell = Cell(entry["name"], {}, entry, params, {}, [], [])
    drv = Driver(cell, 0, device)
    ref = drv.reference_model().requires_grad_(False)  # the counter's module hooks want no
    # tensor that asks for a gradient
    frames = traffic.StreamFrames(params, drv.ref_cfg, 0, device)
    from bench_h100.counts import taps
    from bench_h100.reference.hipad.ops import sampling

    plain = sampling.coarse_sample
    calls = []

    def kept(acc, maps, pts, weights, levels):
        calls.append((acc, maps, pts, weights, levels))
        return plain(acc, maps, pts, weights, levels)

    sampling.coarse_sample = kept
    banks, out = None, {}
    for i in range(2):
        calls.clear()
        images, metas_np = frames.frame(i)
        metas = {k: torch.from_numpy(v).to(device) for k, v in metas_np.items()}
        t = time.perf_counter()
        with FlopCounterMode(display=False) as fc:
            _, banks = ref(images.to(device), metas, banks)
        if device.type == "cuda":
            torch.cuda.synchronize()
        dense = sparse = 0
        for acc, maps, pts, weights, levels in calls:
            bs, m0, cams, _ = pts.shape
            dense += sum(2 * bs * cams * m0 * m.shape[2] * m.shape[3] * m.shape[4] for m in maps)
            sparse += taps.coarse_sample_work(acc, maps, pts, weights, levels)[1]
        out[f"frame{i}"] = {"flops": fc.get_total_flops() - dense + sparse,
                            "counted": fc.get_total_flops(), "dense_coarse": dense,
                            "coarse_taps": sparse, "seconds": time.perf_counter() - t}
    sampling.coarse_sample = plain
    return out


if __name__ == "__main__":
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    from bench_h100.harness import spec

    params = spec.load_json(spec.HERE / "traffic" / "stream_frames.json")
    for name in sys.argv[1:]:
        entry = spec.load_json(spec.HERE / "configs" / f"{name}.json")
        print(json.dumps({"config": name, "device": str(dev), **count(entry, params, dev)}),
              flush=True)
