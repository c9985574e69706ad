"""The port's int8 accuracy harness (``experiments/int8_accuracy.py``) end
to end on the CPU at a small depth and size: it writes the synthetic
dataset, trains through ``tools.train_source``, and reports float against
int8 for every calibration setting. With 3 training iterations the mIoU
means nothing; the test holds the report's structure, that every setting
quantizes every backbone site, and that the argmax agreement is a share."""

from __future__ import annotations

import json

import pytest
import torch

from maxsquareloss_torch.experiments import int8_accuracy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_int8_accuracy_harness_reports_every_setting(tmp_path):
    out = tmp_path / "report.json"
    report = int8_accuracy.main([
        "--prepare", str(tmp_path / "run"), "--blocks", "1,1,2,1", "--h", "64", "--w", "128",
        "--batch", "4", "--n_images", "8", "--n_val", "8", "--train_iters", "3",
        "--calib_batches", "1,2", "--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(report))
    assert set(report["variants"]) == {"amax/calib1", "amax/calib2", "p99.9/calib1",
                                       "p99.9/calib2"}
    for v in report["variants"].values():
        assert len(v["amax"]) == 20 and all(r > 0 for r in v["amax"].values())
        assert 0.0 <= v["argmax_agreement"] <= 1.0
        assert len(v["iou_delta_per_class"]) == 19
    assert set(report["dispersion"]) == {"amax", "p99.9"}
    assert all(d["max_site_ratio"] >= 1.0 for d in report["dispersion"].values())
    assert report["device"] == "cpu"
