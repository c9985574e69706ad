"""The ``train`` kind: the port's UDA train step in a closed loop.

Set-up makes the weights and a pool of ``pool`` distinct (source images,
source labels, target images) batches on the card from the seed, builds the
step object (``make_uda_train_step`` over ``make_train_state``) and drives
it through ``checked_steps`` steps on the pool's first batches, recording
each step's loss, the first gradient from the optimizer's state and each
leaf's change. The window continues the same object over the pool's next
batches, cycling. The check frees the program and runs the plain
reference's steps from the same weights over the same batches. The model
is the configuration's architecture (``models/<backbone>.py``).
"""

from __future__ import annotations

import torch

from maxsquareloss_torch.train.steps import make_train_state, make_uda_train_step
from portbench import compare, flops, harness, models
from portbench.reference import lowp, uda

CHECKS = ("loss_gap", "grad_gap", "change_gap")


def make_pool(cell, seed: int, device, tag: str = "inputs"):
    """(source images, source labels, target images), each (pool, batch,
    ...), from the seed's ``tag`` stream."""
    m, tr, t = cell.config["model"], cell.config["train"], cell.traffic
    n, pool, c = t["batch"], t["pool"], m["num_classes"]
    (sw, sh), (tw, th) = tr["crop_size"], tr["target_crop_size"]
    g = harness.generator(seed, tag, device)
    xs = harness.make_images(g, (pool, n, sh, sw), device)
    ys = harness.make_labels(g, (pool, n, sh, sw), c, t["label_block"], t["ignore_share"],
                             device)
    xt = harness.make_images(g, (pool, n, th, tw), device)
    return xs, ys, xt


def step_work(cell) -> dict:
    """The architecture's work of one card's step, with the fused IW loss
    over its target logits."""
    m, tr, t = cell.config["model"], cell.config["train"], cell.traffic
    tw, th = tr["target_crop_size"]
    return {**models.load(cell.config).step_work(cell),
            "iw_loss": {"launches": flops.iw_loss_work(t["batch"], th, tw, m["num_classes"]),
                        "peak_flops": cell.peaks["flops"]["float32"]}}


class Driver:
    def __init__(self, cell, seed: int, device, tag: str = "inputs",
                 phases: harness.Phases | None = None):
        self.cell, self.device = cell, device
        self.arch = models.load(cell.config)
        self.phases = phases or harness.Phases()
        self.cfg = self.arch.train_config(cell, device)
        self.sd0 = self.arch.make_weights(cell.config["model"], seed, device)
        self.phases.mark("weights")
        self.xs, self.ys, self.xt = make_pool(cell, seed, device, tag)
        self.phases.mark("inputs")
        self.images_per_step = 2 * cell.traffic["batch"]
        model = self.arch.port_model(self.cfg, self.sd0, device, eval_mode=False)
        self._join()
        self.state = make_train_state(model, self.cfg)
        self.step = self._make_step()
        self.phases.mark("model")
        self.checked = cell.traffic["checked_steps"]
        self.program = self._checked_steps(model)
        self.phases.mark("checked_steps")
        self.losses: list[torch.Tensor] = []
        self.attempted = self.failed = 0

    def _join(self) -> None:
        """Join the other ranks before the step object is made (one card:
        nothing to join)."""

    def _make_step(self):
        return make_uda_train_step(self.cfg)

    def _checked_steps(self, model) -> dict:
        params = self.arch.port_params(model)
        losses, grads = [], {}
        for i in range(self.checked):
            _, metrics = self.step(self.state, self.xs[i], self.ys[i], self.xt[i])
            losses.append(metrics["loss"])
            if i == 0:
                grads = self.arch.first_gradient_norms(self.state.optimizer, params, self.sd0,
                                                       self.cfg)
        changes = {k: (p.detach() - self.sd0[k]).double().norm() for k, p in params.items()}
        return {"losses": [float(v) for v in losses],
                "grad_norms": {k: float(v) for k, v in grads.items()},
                "change_norms": {k: float(v) for k, v in changes.items()}}

    def unit(self, k: int) -> None:
        i = (self.checked + k) % self.xs.shape[0]
        _, metrics = self.step(self.state, self.xs[i], self.ys[i], self.xt[i])
        self.losses.append(metrics["loss"])

    def finish(self) -> None:
        harness.sync(self.device)
        self.attempted = len(self.losses)
        self.failed = int((~torch.isfinite(torch.stack(self.losses))).sum())

    def e2e(self, units: int, seconds: float) -> dict:
        return {"train_images_per_s": units * self.images_per_step / seconds}

    def work(self) -> dict:
        return step_work(self.cell)

    def batches(self, half: bool = False):
        """The checked steps' batches, each one share (xs, ys, xt)."""
        n = self.xs.shape[1] // 2 if half else self.xs.shape[1]
        return [[(self.xs[i, :n], self.ys[i, :n], self.xt[i, :n])] for i in range(self.checked)]

    def release_program(self) -> None:
        """Free the step object, the pool past the checked batches."""
        keep = slice(0, self.checked)
        self.xs, self.ys, self.xt = (t[keep].clone() for t in (self.xs, self.ys, self.xt))
        del self.state, self.step, self.losses
        harness.release()

    def reference(self, lower: bool = False, half: bool = False) -> dict:
        """The reference's checked steps: in float32 with TF32 off, or
        (``lower``) one precision below the cell's (``reference/lowp.py``);
        ``half``: over the first half of each batch (a planted fault)."""
        return reference_steps(self.cell, self.sd0, self.batches(half), lower)

    def measure(self) -> dict:
        self.release_program()
        return compare.train_gaps(self.program, self.reference())


def reference_steps(cell, sd0: dict, steps, lower: bool = False) -> dict:
    """The plain reference's steps over ``steps`` (``uda.train_steps``), in
    float32 with TF32 off or (``lower``) one precision below the cell's."""
    dtype = cell.traffic["dtype"]
    lowp.set_tf32(lower and dtype == "float32")
    quant = lowp.fp8_e4m3 if lower and dtype == "bfloat16" else None
    plain = models.load(cell.config).reference(cell.config["model"])
    out = uda.train_steps(sd0, plain, cell.config["train"], steps, quant)
    harness.set_precision(cell.config)
    return out
