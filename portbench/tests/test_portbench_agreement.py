"""At a small size on the CPU the plain reference agrees with the port's
train step, evaluation step and predict function (float32), and the runs
come out correct."""

import time

import pytest

from portbench import calibrate, harness, models
from portbench.tests.small import small

TRAIN_AGREE = {"loss_gap": 1e-5, "grad_gap": 1e-3, "change_gap": 1e-3}


@pytest.mark.parametrize("cell", ["gta5_uda_bf16", "synthia16_uda_fp32"])
def test_train_step_agrees(cell):
    r = harness.run_cell(cell, 2**31 + 17, 0.5, False, time.perf_counter(), device="cpu",
                         patch=small("float32"))
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    for k, tol in TRAIN_AGREE.items():
        assert r["checks"][k]["value"] < tol, (k, r["checks"][k])
    assert set(r["metrics"]) == {"train_images_per_s", "setup_s"}


@pytest.mark.parametrize("cell", ["gta5_eval_tta_bf16", "synthia16_serve_b1_bf16"])
def test_eval_and_predict_agree(cell):
    r = harness.run_cell(cell, 3, 0.5, False, time.perf_counter(), device="cpu",
                         patch=small("float32"))
    assert r["correct"] and r["failed"] == 0 and list(r)[-1] == "checks"
    numbers = calibrate.readings(cell, 3, "program", "cpu", small("float32"))["checks"]
    assert numbers["score_gap"] < 1e-4 and numbers["score_gap_mean"] < 1e-7, numbers
    assert numbers.get("cm_entries_wrong", 0) == 0 and numbers.get("pixels_missing", 0) == 0


def test_bf16_train_step_within_its_limits():
    r = harness.run_cell("gta5_uda_bf16", 11, 0.5, False, time.perf_counter(), device="cpu",
                         patch=small())
    assert r["failed"] == 0
    assert all(0 < c["value"] < 5e-2 for c in r["checks"].values()), r["checks"]


def test_same_seed_same_inputs():
    cell = harness.load_cell("gta5_uda_bf16", small())
    make_weights = models.load(cell.config).make_weights
    a = make_weights(cell.config["model"], 2**40 + 3, "cpu")
    b = make_weights(cell.config["model"], 2**40 + 3, "cpu")
    c = make_weights(cell.config["model"], 2**40 + 4, "cpu")
    assert all((a[k] == b[k]).all() for k in a)
    assert not (a["conv1.weight"] == c["conv1.weight"]).all()
    assert float(a["layer1.1.bn3.weight"][0]) == pytest.approx(0.1)
