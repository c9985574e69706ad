"""Counts of ``portbench/flops.py`` from shapes."""

import pytest

from portbench import flops

R101 = (3, 4, 23, 3)


def test_identity_blocks_of_the_gta5_train_step():
    blocks = flops.identity_blocks(R101, 4, (640, 1280)) + flops.identity_blocks(R101, 4, (512, 1024))
    assert len(blocks) == 58
    total = sum(flops.identity_block_work(b, True, 2)[0] for b in blocks)
    assert total / 1e12 == pytest.approx(5.97, abs=0.005)


def test_map_sizes():
    assert flops.stem_hw((640, 1280)) == {"stem": (320, 640), "os4": (161, 321), "os8": (81, 161)}
    assert flops.stem_hw((760, 1280))["os8"] == (96, 161)
    assert flops.stem_hw((512, 1024))["os8"] == (65, 129)


def test_step_and_forward_counts():
    gta5 = flops.uda_step_flops(R101, 19, 4, (640, 1280), 4, (512, 1024))
    assert gta5 / 1e12 == pytest.approx(23.25, abs=0.01)
    # three times a forward of both heads, less the stem's input gradient
    fwd = flops.forward_flops(R101, 19, 4, (640, 1280)) + flops.forward_flops(R101, 19, 4, (512, 1024))
    stem = sum(c.flops for hw in ((640, 1280), (512, 1024))
               for c in flops.forward_convs(R101, 19, 4, hw) if c.name == "stem")
    assert gta5 == 3 * fwd - stem
    tta = flops.tta_flops(R101, 19, 1, (512, 1024), (0.75, 1.0, 1.25), True)
    one = flops.forward_flops(R101, 19, 1, (512, 1024), aux=False)
    serve = flops.forward_flops(R101, 16, 1, (512, 1024), aux=False)
    assert tta == 2 * (one + flops.forward_flops(R101, 19, 1, (384, 768), aux=False)
                       + flops.forward_flops(R101, 19, 1, (640, 1280), aux=False))
    assert serve / 1e12 == pytest.approx(0.744, abs=0.001)


def test_block_bytes_and_bound():
    b = flops.Block(2, 65, 129, 1024, 256, 2)
    f, n = flops.identity_block_work(b, False, 4)
    px = 2 * 65 * 129
    assert f == 2 * px * (2 * 1024 * 256 + 9 * 256 * 256)
    assert n == 4 * (2 * px * 1024 + 2 * 1024 * 256 + 9 * 256 * 256) + 4 * (4 * 256 + 2 * 1024)
    assert flops.identity_block_work(b, True, 4)[1] - n == 4 * 2 * px * 256
    assert flops.bound_seconds([(67e12, 1.0), (1.0, 3.35e12)], 67e12, 3.35e12) == pytest.approx(2.0)
    fwd, bwd = flops.iw_loss_work(4, 512, 1024, 19)
    m = 4 * 512 * 1024 * 19
    assert fwd == (10 * m, 4 * m + 4 * 4 * 19 + 4) and bwd == (14 * m, 8 * m + 4 * 4 * 19 + 4)
