"""The ``train`` kind: the port's UDA train step in a closed loop.

Set-up makes the weights and a pool of ``pool`` distinct (source images,
source labels, target images) batches on the card from the seed, builds the
step object (``make_uda_train_step`` over ``make_train_state``) and drives
it through ``checked_steps`` steps on the pool's first batches, recording
each step's loss, the first gradient from the optimizer's momentum buffers
and each leaf's change. The window continues the same object over the
pool's next batches, cycling. The check frees the program and runs the
plain reference's steps from the same weights over the same batches.
"""

from __future__ import annotations

import torch

from maxsquareloss_torch.train.steps import make_train_state, make_uda_train_step
from portbench import compare, flops, harness, program
from portbench.reference import deeplabv2 as ref_model
from portbench.reference import lowp, uda


class Driver:
    def __init__(self, cell, seed: int, device):
        self.cell, self.device = cell, device
        self.phases = harness.Phases()
        m, tr, t = cell.config["model"], cell.config["train"], cell.traffic
        self.cfg = program.train_config(cell, device)
        n, pool, c = t["batch"], t["pool"], m["num_classes"]
        (sw, sh), (tw, th) = tr["crop_size"], tr["target_crop_size"]
        self.sd0 = harness.make_weights(m, seed, device)
        self.phases.mark("weights")
        g = harness.generator(seed, "inputs", device)
        self.xs = harness.make_images(g, (pool, n, sh, sw), device)
        self.ys = harness.make_labels(g, (pool, n, sh, sw), c, t["label_block"],
                                      t["ignore_share"], device)
        self.xt = harness.make_images(g, (pool, n, th, tw), device)
        self.phases.mark("inputs")
        self.images_per_step = 2 * n
        model = program.port_model(self.cfg, self.sd0, device, eval_mode=False)
        self.state = make_train_state(model, self.cfg)
        self.step = make_uda_train_step(self.cfg)
        self.phases.mark("model")
        self.checked = t["checked_steps"]
        self.program = self._checked_steps(model)
        self.phases.mark("checked_steps")
        self.losses: list[torch.Tensor] = []
        self.attempted = self.failed = 0

    def _checked_steps(self, model) -> dict:
        params = dict(model.named_parameters())
        opt = self.state.optimizer
        losses, grads = [], {}
        for i in range(self.checked):
            _, metrics = self.step(self.state, self.xs[i], self.ys[i], self.xt[i])
            losses.append(metrics["loss"])
            if i == 0:  # the gradient the optimizer got: buf = g + wd * p0 (none: 0)
                wd = self.cfg.weight_decay
                bufs = {k: opt.state.get(p, {}).get("momentum_buffer") for k, p in params.items()}
                grads = {k: torch.zeros((), dtype=torch.float64) if b is None
                         else (b - wd * self.sd0[k]).double().norm() for k, b in bufs.items()}
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
        m, tr, t = self.cell.config["model"], self.cell.config["train"], self.cell.traffic
        n, c, peaks = t["batch"], m["num_classes"], self.cell.peaks
        (sw, sh), (tw, th) = tr["crop_size"], tr["target_crop_size"]
        peak = peaks["flops"][t["dtype"]]
        itemsize = 2 if t["dtype"] == "bfloat16" else 4
        blocks = (flops.identity_blocks(m["blocks"], n, (sh, sw))
                  + flops.identity_blocks(m["blocks"], n, (th, tw)))
        return {
            "model_flops": flops.uda_step_flops(m["blocks"], c, n, (sh, sw), n, (th, tw)),
            "peak_flops": peak,
            "identity_blocks": {"launches": [flops.identity_block_work(b, True, itemsize)
                                             for b in blocks], "peak_flops": peak},
            "iw_loss": {"launches": flops.iw_loss_work(n, th, tw, c),
                        "peak_flops": peaks["flops"]["float32"]},
        }

    def batches(self, half: bool = False):
        n = self.xs.shape[1] // 2 if half else self.xs.shape[1]
        return [(self.xs[i, :n], self.ys[i, :n], self.xt[i, :n]) for i in range(self.checked)]

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
        dtype = self.cell.traffic["dtype"]
        ref_model.set_tf32(lower and dtype == "float32")
        quant = lowp.fp8_e4m3 if lower and dtype == "bfloat16" else None
        out = uda.train_steps(self.sd0, self.cell.config["model"]["blocks"],
                              self.cell.config["train"], self.batches(half), quant)
        harness.set_precision(self.cell.config)
        return out

    def measure(self) -> dict:
        self.release_program()
        return compare.train_gaps(self.program, self.reference())
