"""A new architecture is a module under ``portbench/models`` and a
configuration that names it: a toy with one head (one strided conv to the
classes), registered as such a module here, runs through the ``train``
driver on the CPU with no driver edited, and the port's step over it
agrees with its plain forward through the reference's UDA step, which
without an aux head has no guidance CE."""

import dataclasses
import functools
import sys
import time
import types

import pytest
import torch
import torch.nn.functional as F

from portbench import harness
from portbench.models import deeplabv2_multi
from portbench.reference import uda
from portbench.tests.small import small

NAME = "toy_single_head"
STRIDE = 8
AGREE = {"loss_gap": 1e-5, "grad_gap": 1e-4, "change_gap": 1e-4}


class ToyPort(torch.nn.Module):
    """NHWC images → (no aux head, NHWC float32 logits at stride 8)."""

    def __init__(self, num_classes: int):
        super().__init__()
        self.head = torch.nn.Conv2d(3, num_classes, STRIDE, stride=STRIDE)

    def forward(self, x, aux=True, masks=None, space=None, in_h=None):
        return None, self.head(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).float()

    def pack_weights(self):
        pass


def _reference_forward(sd, x, aux=True, quant=None):
    w = sd["head.weight"] if quant is None else quant(sd["head.weight"])
    x = x if quant is None else quant(x)
    return None, F.conv2d(x, w, sd["head.bias"], stride=STRIDE)


def _toy_module() -> types.ModuleType:
    mod = types.ModuleType(f"portbench.models.{NAME}")

    def make_weights(model, seed, device):
        c = model["num_classes"]
        w = torch.randn((c, 3, STRIDE, STRIDE), generator=harness.generator(seed, "weights", device),
                        device=device)
        return {"head.weight": w * 0.01, "head.bias": torch.zeros(c, device=device)}

    def train_config(cell, device):
        return dataclasses.replace(deeplabv2_multi.train_config(cell, device), multi=False)

    def port_model(cfg, sd, device, eval_mode):
        model = ToyPort(cfg.num_classes).to(device)
        model.load_state_dict(sd)
        return model

    def step_work(cell):
        return {"model_flops": 1, "peak_flops": cell.peaks["flops"][cell.traffic["dtype"]]}

    mod.make_weights, mod.train_config, mod.port_model = make_weights, train_config, port_model
    mod.port_params = deeplabv2_multi.port_params
    mod.first_gradient_norms = deeplabv2_multi.first_gradient_norms
    mod.reference = lambda model: uda.Plain(
        forward=_reference_forward, trainable=lambda key: True,
        optimizer=functools.partial(uda.SGD, is_head=lambda key: False))
    mod.step_work = step_work
    return mod


@pytest.fixture
def toy(monkeypatch):
    monkeypatch.setitem(sys.modules, f"portbench.models.{NAME}", _toy_module())
    return harness.merge(small("float32"), {"config": {"model": {"backbone": NAME,
                                                                  "multi": False}}})


def test_toy_architecture_through_the_train_driver(toy):
    r = harness.run_cell("gta5_uda_bf16", 2**32 + 5, 0.5, False, time.perf_counter(),
                         device="cpu", patch=toy)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    for k, tol in AGREE.items():
        assert r["checks"][k]["value"] < tol, (k, r["checks"][k])


def test_toy_reference_has_no_guidance_ce(toy):
    """Without an aux head the reference's loss is the source CE plus the
    weighted IW loss alone."""
    cell = harness.load_cell("gta5_uda_bf16", toy)
    sd = _toy_module().make_weights(cell.config["model"], 3, "cpu")
    from portbench.drivers.train import make_pool

    xs, ys, xt = (t[0] for t in make_pool(cell, 3, "cpu"))
    train = cell.config["train"]
    total = uda.uda_loss(sd, _reference_forward, train, xs, ys, xt)
    main_s = uda.upsample(_reference_forward(sd, uda.normalize(xs))[1], ys.shape[-2:])
    main_t = uda.upsample(_reference_forward(sd, uda.normalize(xt))[1], xt.shape[1:3])
    want = uda.ce(main_s, ys) + train["lambda_target"] * uda.iw_max_square(
        F.softmax(main_t, dim=1), None, train["IW_ratio"])
    assert float(total) == pytest.approx(float(want), rel=1e-6)
