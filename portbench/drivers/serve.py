"""The ``serve`` kind: one client, one request outstanding at a time, as the
``predict`` CLI serves an image.

Set-up makes the weights on the card and a host pool of ``pool`` uint8
images at the configuration's eval size from the seed, builds
``make_predict_fn`` over the eval-form model for the label size and warms
it up. Each request hands a pool image (in turn) to the card, runs the
function and copies its int32 trainIds back to the host; its latency runs
from the hand-over to the trainIds on the host. A sample of ``sample``
answers, drawn from the seed by reservoir sampling, is kept for the check.
The model is the configuration's architecture (``models/<backbone>.py``).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from maxsquareloss_torch.predict import make_predict_fn
from portbench import compare, harness, models
from portbench.drivers.eval import Reservoir
from portbench.reference import evaluate as ref_eval
from portbench.reference import lowp

CHECKS = ("score_gap_mean",)


def make_pool(cell, seed: int, device) -> np.ndarray:
    """A host pool of uint8 images at the eval size, made on the device
    from the seed."""
    w, h = cell.config["eval"]["base_size"]
    g = harness.generator(seed, "inputs", device)
    return harness.make_images(g, (cell.traffic["pool"], h, w), device).cpu().numpy()


class Driver:
    def __init__(self, cell, seed: int, device, int8: bool = False):
        self.cell, self.device = cell, device
        self.arch = models.load(cell.config)
        self.phases = harness.Phases()
        t = cell.traffic
        self.cfg = self.arch.train_config(cell, device)
        lw, lh = cell.config["eval"]["label_size"]
        self.out_hw = (lh, lw)
        self.sd0 = self.arch.make_weights(cell.config["model"], seed, device)
        self.phases.mark("weights")
        self.pool = make_pool(cell, seed, device)
        self.phases.mark("inputs")
        self.scales, self.flip = tuple(t["scales"]), bool(t["flip"])
        self.model = self.arch.port_model(self.cfg, self.sd0, device, eval_mode=True)
        if int8:  # the program's own lower-precision path: the control
            first = torch.from_numpy(self.pool[:1]).to(device)
            self.model = self.arch.port_int8(self.model, self.cfg, [first])
        self.fn = make_predict_fn(self.cfg, self.model, self.scales, self.flip, self.out_hw)
        self.phases.mark("model")
        for i in range(t["warmup_units"]):
            self.fn(torch.from_numpy(self.pool[i % t["pool"]][None]).to(device)).cpu()
        self.phases.mark("warmup")
        self.latency: list[float] = []
        self.sample = Reservoir(t["sample"], seed)
        self.attempted = self.failed = 0

    def unit(self, k: int) -> None:
        i = k % self.pool.shape[0]
        t0 = time.perf_counter()
        x = torch.from_numpy(self.pool[i][None]).to(self.device)
        ids = self.fn(x).cpu()
        self.latency.append(time.perf_counter() - t0)
        if ids.shape != (1, *self.out_hw) or ids.dtype != torch.int32:
            self.failed += 1
        self.sample.offer(lambda: (i, ids[0]))

    def finish(self) -> None:
        harness.sync(self.device)
        self.attempted = len(self.latency)
        ms = np.array(self.latency) * 1e3
        third = max(1, len(ms) // 3)
        print(f"portbench: serve ms: n {len(ms)} p5/p50/p95/p99/max "
              f"{np.percentile(ms, [5, 50, 95, 99, 100]).round(3).tolist()} median of the first "
              f"and last third {np.median(ms[:third]):.3f} {np.median(ms[-third:]):.3f}",
              file=sys.stderr)

    def e2e(self, units: int, seconds: float) -> dict:
        return {"serve_p95_ms": float(np.percentile(np.array(self.latency) * 1e3, 95))}

    def work(self) -> dict:
        return self.arch.tta_work(self.cell, 1)

    def measure(self) -> dict:
        sample = list(self.sample.items)
        del self.fn, self.model
        harness.release()
        lowp.set_tf32(False)
        stats = None
        views = len(self.scales) * (2 if self.flip else 1)
        forward = self.arch.reference(self.cell.config["model"]).forward
        for i, ids in sample:
            image = torch.from_numpy(self.pool[i]).to(self.device)
            score = ref_eval.tta_scores(self.sd0, forward, image, self.scales, self.flip,
                                        self.out_hw)
            stats = compare.merge_stats(stats, compare.score_stats(score, ids, views))
            del score
        harness.set_precision(self.cell.config)
        del stats["n"]
        return stats
