"""The ``eval`` kind: the port's multi-scale (+flip) evaluation step in a
closed loop, as ``tools/evaluate.py`` drives it.

Set-up makes the weights and a pool of ``pool`` distinct batches (uint8
images at the configuration's eval size, int32 labels at its label size)
on the card from the seed, builds ``make_multiscale_eval_step`` over the
eval-form model and warms it up on one batch. The window runs the step over
the pool, cycling, and sums the confusion matrices on the card; a sample
of ``sample`` batches, drawn from the seed by reservoir sampling, keeps its
predictions and matrix for the check. The model is the configuration's
architecture (``models/<backbone>.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from maxsquareloss_torch.train.evaluator import make_multiscale_eval_step
from portbench import compare, harness, models
from portbench.reference import evaluate as ref_eval
from portbench.reference import lowp

CHECKS = ("score_gap_vs_bf16", "cm_entries_wrong", "pixels_missing")


def make_pool(cell, seed: int, device):
    """uint8 images at the eval size and int32 labels at the label size,
    each (pool, batch, ...), from the seed."""
    m, ev, t = cell.config["model"], cell.config["eval"], cell.traffic
    (w, h), (lw, lh) = ev["base_size"], ev["label_size"]
    g = harness.generator(seed, "inputs", device)
    n, pool = t["batch"], t["pool"]
    x = harness.make_images(g, (pool, n, h, w), device)
    y = harness.make_labels(g, (pool, n, lh, lw), m["num_classes"], t["label_block"],
                            t["ignore_share"], device)
    return x, y


class Reservoir:
    """A uniform sample of ``size`` items of a stream, drawn from the seed."""

    def __init__(self, size: int, seed: int):
        self.size, self.items, self.seen = size, [], 0
        self.rng = np.random.default_rng(harness.sub_seed(seed, "sample"))

    def offer(self, make):
        """Keep ``make()`` if the draw says so."""
        slot = self.seen if self.seen < self.size else int(self.rng.integers(0, self.seen + 1))
        self.seen += 1
        if slot < self.size:
            item = make()
            if slot < len(self.items):
                self.items[slot] = item
            else:
                self.items.append(item)


class Driver:
    def __init__(self, cell, seed: int, device, int8: bool = False):
        self.cell, self.device = cell, device
        self.arch = models.load(cell.config)
        self.phases = harness.Phases()
        t, pool = cell.traffic, cell.traffic["pool"]
        self.cfg = self.arch.train_config(cell, device)
        self.sd0 = self.arch.make_weights(cell.config["model"], seed, device)
        self.phases.mark("weights")
        self.c = cell.config["model"]["num_classes"]
        self.x, self.y = make_pool(cell, seed, device)
        self.phases.mark("inputs")
        self.scales, self.flip = tuple(t["scales"]), bool(t["flip"])
        self.model = self.arch.port_model(self.cfg, self.sd0, device, eval_mode=True)
        if int8:  # the program's own lower-precision path: the control
            self.model = self.arch.port_int8(self.model, self.cfg, [self.x[0]])
        self.step = make_multiscale_eval_step(self.cfg, self.model, self.scales, self.flip)
        self.phases.mark("model")
        for i in range(t["warmup_units"]):
            self.step(self.x[i % pool], self.y[i % pool])
        harness.sync(device)
        self.phases.mark("warmup")
        self.cm = torch.zeros((self.c, self.c), dtype=torch.int64, device=device)
        self.sample = Reservoir(t["sample"], seed)
        self.done = torch.zeros(pool, dtype=torch.int64)
        self.attempted = self.failed = 0

    def unit(self, k: int) -> None:
        i = k % self.x.shape[0]
        cm, pred = self.step(self.x[i], self.y[i])
        self.cm += cm
        self.done[i] += 1
        self.sample.offer(lambda: (i, cm, pred))

    def finish(self) -> None:
        harness.sync(self.device)
        self.attempted = int(self.done.sum())
        self.failed = 0

    def e2e(self, units: int, seconds: float) -> dict:
        return {"eval_images_per_s": units * self.x.shape[1] / seconds}

    def work(self) -> dict:
        return self.arch.tta_work(self.cell, self.cell.traffic["batch"])

    def measure(self) -> dict:
        sample = [(i, cm, pred) for i, cm, pred in self.sample.items]
        valid = ((self.y >= 0) & (self.y < self.c)).flatten(1).sum(1).cpu()
        missing = abs(int(self.cm.sum()) - int((valid * self.done).sum()))
        del self.step, self.model, self.cm
        harness.release()
        lowp.set_tf32(False)
        stats, plain, cm_wrong = None, None, 0
        views = len(self.scales) * (2 if self.flip else 1)
        out_hw = tuple(self.cell.config["eval"]["label_size"][::-1])
        forward = self.arch.reference(self.cell.config["model"]).forward
        for i, cm, pred in sample:
            cm_wrong += int((ref_eval.confusion_matrix(self.y[i], pred, self.c) != cm).sum())
            for j in range(pred.shape[0]):
                args = (self.sd0, forward, self.x[i, j], self.scales, self.flip, out_hw)
                score = ref_eval.tta_scores(*args)
                stats = compare.merge_stats(stats, compare.score_stats(score, pred[j], views))
                bf16 = ref_eval.tta_scores(*args, dtype=torch.bfloat16).argmax(0)
                plain = compare.merge_stats(plain, compare.score_stats(score, bf16, views))
                del score, bf16
        harness.set_precision(self.cell.config)
        del stats["n"]
        stats["score_gap_vs_bf16"] = stats["score_gap_mean"] / max(plain["score_gap_mean"], 1e-30)
        return {**stats, "cm_entries_wrong": cm_wrong, "pixels_missing": missing}
