"""The weights and inputs that each cell made at the small size from seed 0
before the architecture modules (sha256 pinned): the code that moved makes
the same values, so each cell's readings at a seed are unchanged."""

import hashlib
import importlib

import numpy as np
import pytest
import torch

from portbench import harness, models
from portbench.tests.small import small

PINNED = {  # cell: (weights, inputs)
    "gta5_uda_bf16": ("0fd985dd8b198b47c5bfebfba8b5566a7450671af11298677805dae275b9e891",
                      "381e41817c8d2ea0e1ff4b67276be422f18e0dfadb3f3927d0d27c8a5fa9c7ee"),
    "gta5_eval_tta_bf16": ("0fd985dd8b198b47c5bfebfba8b5566a7450671af11298677805dae275b9e891",
                           "dea72b2516b8e22994c752089f1d823e13594bda2413b487cab2670d8e4033a2"),
    "synthia16_uda_fp32": ("fe2425027fde90e2f5dc98a75539acdc30cf415556099b5d1934c4f257d80e93",
                           "9c7fc194d2df63047deba9af5b4c92cf438a0f2cf8878f4c56fed8ed3e7985c9"),
    "synthia16_serve_b1_bf16": (
        "fe2425027fde90e2f5dc98a75539acdc30cf415556099b5d1934c4f257d80e93",
        "20c73336fc5bd35deecc0a071ca9b298a742d6740754b340df2de10980e0d1fe"),
}
INPUT_NAMES = {"train": ("xs", "ys", "xt"), "eval": ("x", "y"), "serve": ("pool",)}


def digest(tensors: dict) -> str:
    """sha256 over each name and its contiguous bytes, in order."""
    h = hashlib.sha256()
    for name, t in tensors.items():
        h.update(name.encode())
        h.update(np.ascontiguousarray(t).tobytes() if isinstance(t, np.ndarray)
                 else t.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(PINNED))
def test_weights_and_inputs_pinned(name):
    cell = harness.load_cell(name, small())
    kind = cell.traffic["kind"]
    sd = models.load(cell.config).make_weights(cell.config["model"], 0, "cpu")
    pool = importlib.import_module(f"portbench.drivers.{kind}").make_pool(
        cell, 0, torch.device("cpu"))
    pool = pool if isinstance(pool, tuple) else (pool,)
    assert (digest(sd), digest(dict(zip(INPUT_NAMES[kind], pool, strict=True)))) == PINNED[name]
