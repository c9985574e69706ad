"""The trace reader and the per-layer readers on a made-up trace."""

import pytest

from portbench.readers import exposed, idle, mfu, roofline
from portbench.trace import Trace


def _trace():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "portbench.window", "ts": 1000, "dur": 1000},
          {"ph": "X", "cat": "kernel", "name": "void fused_bottleneck_kernel<3>(Args)", "ts": 900, "dur": 300},
          {"ph": "X", "cat": "kernel", "name": "ms_fwd_kernel<19>", "ts": 1300, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "other", "ts": 1350, "dur": 100},  # overlaps
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 1900, "dur": 200},
          {"ph": "X", "cat": "cpu_op", "name": "aten::bincount", "ts": 1450, "dur": 400, "tid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 1600, "dur": 100, "tid": 1}]
    return Trace(ev)


def test_union_clip_and_gaps():
    t = _trace()
    assert t.window_s == pytest.approx(1e-3)
    # [1000,1200] + [1300,1450] + [1900,2000] inside the window
    assert t.busy_s == pytest.approx(450e-6)
    assert t.device_time(["fused_bottleneck_kernel"]) == pytest.approx(200e-6)
    gaps = t.idle_gaps(10)
    assert gaps[0][0] == "aten::item" and gaps[0][1] == pytest.approx(450e-6)
    assert [g[1] for g in gaps] == sorted((g[1] for g in gaps), reverse=True)
    assert t.top_ops(1)[0][0].startswith("void fused_bottleneck_kernel")


def test_readers():
    t = _trace()
    ctx = {"units": 2, "model_flops": 1e9, "peak_flops": 1e12,
           "identity_blocks": {"launches": [(1e6, 0)], "peak_flops": 1e12}}
    assert mfu.read(t, ctx, {}, {"bytes_per_s": 1e12}) == pytest.approx(100 * 2e9 / 1e-3 / 1e12)
    spec = {"work": "identity_blocks", "kernels": ["fused_bottleneck_kernel"]}
    assert roofline.read(t, ctx, spec, {"bytes_per_s": 1e12}) == pytest.approx(100 * 2e-6 / 200e-6)
    assert roofline.read(t, ctx, {**spec, "kernels": ["nothing"]}, {"bytes_per_s": 1}) is None
    assert roofline.read(t, ctx, {**spec, "work": "iw_loss"}, {"bytes_per_s": 1}) is None
    assert idle.read(t, ctx, {}, {}) == pytest.approx(55.0)


def test_exposed():
    """NCCL kernels' time with nothing else on the device, a unit."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "portbench.window", "ts": 0, "dur": 1000},
          {"ph": "X", "cat": "kernel", "name": "ncclDevKernel_AllReduce_Sum_f32", "ts": 100,
           "dur": 300},
          {"ph": "X", "cat": "kernel", "name": "ncclDevKernel_AllGather", "ts": 350, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "wgrad", "ts": 50, "dur": 150},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD", "ts": 300, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "sgd", "ts": 600, "dur": 100}]
    t = Trace(ev)
    spec = {"kernels": ["nccl"]}
    # NCCL covers [100, 450); others cover [50, 200) and [300, 320): 450 - 100 - 100 - 20 us
    assert exposed.read(t, {"units": 2}, spec, {}) == pytest.approx(230e-3 / 2)
    assert exposed.read(t, {"units": 2}, {"kernels": ["absent"]}, {}) is None
    assert exposed.exposed_us([(0, 10)], [(2, 3), (5, 20)]) == pytest.approx(4)
