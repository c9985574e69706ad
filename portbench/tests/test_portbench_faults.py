"""Runs with the timed path broken underneath (the look for a card skipped,
on the CPU at a small size) come out not correct: a step that leaves its
state unchanged, a step over half of each batch, an answer altered where it
is produced."""

import time

import pytest

import maxsquareloss_torch.train.steps as steps
import portbench.drivers.eval as eval_driver
import portbench.drivers.serve as serve_driver
import portbench.drivers.train as train_driver
from portbench import harness
from portbench.tests.small import small


def _over(r, prefix):
    """Some compared number starting with ``prefix`` is over its limit."""
    return any(c["value"] > c["limit"] for k, c in r["checks"].items() if k.startswith(prefix))


def _run(cell, dtype="float32"):
    return harness.run_cell(cell, 5, 0.5, False, time.perf_counter(), device="cpu",
                            patch=small(dtype))


@pytest.mark.parametrize("cell", ["gta5_uda_bf16", "synthia16_uda_fp32"])
def test_state_left_unchanged(cell, monkeypatch):
    def no_update(state, loss, cfg):
        state.iteration += 1
        return cfg.lr

    monkeypatch.setattr(steps, "_apply_update", no_update)
    r = _run(cell)
    assert not r["correct"]
    assert r["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", ["gta5_uda_bf16", "synthia16_uda_fp32"])
def test_half_of_the_batch(cell, monkeypatch):
    real = train_driver.make_uda_train_step

    def half_step(cfg):
        step = real(cfg)

        def run(state, xs, ys, xt):
            h = xs.shape[0] // 2
            return step(state, xs[:h], ys[:h], xt[:h])

        return run

    monkeypatch.setattr(train_driver, "make_uda_train_step", half_step)
    r = _run(cell)
    assert not r["correct"]
    assert r["checks"]["loss_gap"]["value"] > r["checks"]["loss_gap"]["limit"]


def test_eval_answer_altered(monkeypatch):
    real = eval_driver.make_multiscale_eval_step

    def altered(cfg, model, scales, flip):
        step = real(cfg, model, scales, flip)

        def run(x, y):
            cm, pred = step(x, y)
            pred = pred.clone()
            pred[0] = (pred[0] + 1) % cfg.num_classes
            return cm, pred

        return run

    monkeypatch.setattr(eval_driver, "make_multiscale_eval_step", altered)
    r = _run("gta5_eval_tta_bf16")
    assert not r["correct"] and _over(r, "score")
    assert r["checks"]["cm_entries_wrong"]["value"] > 0


def test_eval_batch_skipped(monkeypatch):
    real = eval_driver.make_multiscale_eval_step

    def skipping(cfg, model, scales, flip):
        step = real(cfg, model, scales, flip)

        def run(x, y):
            h = x.shape[0] // 2
            cm, _ = step(x[:h], y[:h])
            return cm, step(x, y)[1]

        return run

    monkeypatch.setattr(eval_driver, "make_multiscale_eval_step", skipping)
    r = _run("gta5_eval_tta_bf16")
    assert not r["correct"] and r["checks"]["pixels_missing"]["value"] > 0


def test_served_answer_altered(monkeypatch):
    real = serve_driver.make_predict_fn

    def altered(cfg, model, scales, flip, out_hw):
        fn = real(cfg, model, scales, flip, out_hw)
        return lambda x: (fn(x) + 1) % cfg.num_classes

    monkeypatch.setattr(serve_driver, "make_predict_fn", altered)
    r = _run("synthia16_serve_b1_bf16")
    assert not r["correct"] and _over(r, "score")
