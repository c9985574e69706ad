"""The port's serving export (``maxsquareloss_torch/tools/export_inference``,
``torch.export`` with the eval kernel as the custom op
``msl::fused_bottleneck``) on the CPU, against the JAX package's
``tools/export_inference`` serving function from the same ``.pth``.

- The round trip is exact: the loaded artifact equals the live graph
  rebuilt from its sidecar, in fp32 (and with multi-scale + flip), with bf16
  parameters embedded (bitwise the float32-embedded artifact, at under
  0.65 of its size), and in int8 (the sidecar's ranges rebuild the same
  int8 model); ``--load --selftest`` checks it from the sidecar alone.
- Against JAX's serving function on the same weights and uint8 batch:
  trainIds >= 99.9 % equal, fp32 and int8 (the JAX int8 tree quantized
  from the port's recorded ranges); fp32 sums in another order flip only
  near-ties.
- The custom op traces under ``torch.export``: the exported graph holds one
  ``msl.fused_bottleneck`` node per identity block and forward, and none
  when the identity blocks are int8.
- ``--sp`` needs its space group's processes, and refuses int8 as the JAX
  tool does (the sharded export: ``tests/test_torch_spatial_export.py``).
"""

from __future__ import annotations

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, ".")

from maxsquareloss_torch.config import TrainConfig
from maxsquareloss_torch.models.deeplabv2 import init_deeplabv2
from maxsquareloss_torch.optim import make_sgd
from maxsquareloss_torch.tools import export_inference as ex
from maxsquareloss_torch.train import checkpoint as ckpt_lib
from maxsquareloss_torch.train.steps import model_config

BLOCKS = "1,1,2,1"  # layer3 has one identity block, the others none
HW = (32, 64)
COMMON = ["--hw", "32,64", "--batch_size", "2", "--blocks", BLOCKS, "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(.pth path, calibration image glob, seeded uint8 batch)."""
    base = tmp_path_factory.mktemp("export")
    cfg = TrainConfig(blocks=tuple(int(b) for b in BLOCKS.split(",")))
    model = init_deeplabv2(model_config(cfg), torch.Generator().manual_seed(7), device="cpu")
    with torch.no_grad():  # larger heads: fewer near-ties between classes
        for head in (model.layer5, model.layer6):
            for conv in head.conv2d_list:
                conv.weight.mul_(30.0)
    model.pack_weights()
    path = ckpt_lib.save_checkpoint(str(base / "ckpt"), model, make_sgd(model, cfg), 0, 0, 0.0)
    rng = np.random.default_rng(0)
    for i in range(3):  # calibration images at a size other than the export's
        Image.fromarray(rng.integers(0, 256, (40, 70, 3)).astype(np.uint8)).save(
            base / f"calib_{i}.png")
    x = rng.integers(0, 256, size=(2, *HW, 3)).astype(np.uint8)
    return path, str(base / "calib_*.png"), x


def _export(served, out, *extra):
    path = served[0]
    meta = ex.main(["--pretrained_ckpt_file", path, "--output", out, *COMMON, *extra])
    assert meta == json.load(open(out + ".json"))
    return meta


def _run(out, x):
    with torch.no_grad():
        return torch.export.load(out + ".pt2").module()(torch.from_numpy(x))


def _jax_serving(served, compute_dtype, calib_amax=None):
    """The JAX tool's serving function on the same .pth, jitted. (The .pth
    has both heads, so the JAX checkpoint reader alone loads it: the tool's
    ``load_params`` would also draw a fresh model to fill missing heads.)"""
    from maxsquareloss_tpu.config import TrainConfig as JTrainConfig
    from maxsquareloss_tpu.train import checkpoint as jckpt
    from tools.export_inference import make_serving_fn

    cfg = JTrainConfig(blocks=tuple(int(b) for b in BLOCKS.split(",")),
                       compute_dtype=compute_dtype, device_normalize=True,
                       pretrained_ckpt_file=served[0], data_parallel=False)
    params, frozen = jckpt.load_torch_pth(served[0], cfg.num_classes)
    assert {"layer5", "layer6"} <= set(params)
    if calib_amax is not None:
        from maxsquareloss_tpu.models.quantize import quantize_params

        params = quantize_params(params, calib_amax)
    return np.asarray(jax.jit(make_serving_fn(cfg, params, frozen, (1.0,), False, HW))(served[2]))


def test_export_roundtrip_exact_and_matches_jax(tmp_path, served):
    out = str(tmp_path / "serve" / "model")
    meta = _export(served, out, "--compute_dtype", "float32")
    assert meta["input_shape"] == [2, *HW, 3] and meta["out_hw"] == list(HW)
    assert meta["flip"] is False and meta["scales"] == [1.0]
    assert (meta["device"], meta["quantize"], meta["embed_dtype"]) == ("cpu", "", "float32")
    got = _run(out, served[2])
    assert got.shape == (2, *HW) and got.dtype == torch.int32
    assert int(got.min()) >= 0 and int(got.max()) < 19
    cfg = ex._cfg({**meta, "numpy_transform": True, "pretrained_ckpt_file": served[0]})
    live = ex.make_serving_fn(cfg, ex._model(cfg, "cpu"), (1.0,), False, HW)
    with torch.no_grad():
        assert torch.equal(got, live(torch.from_numpy(served[2])))
    want = _jax_serving(served, "float32")
    assert (got.numpy() == want).mean() >= 0.999


def test_export_selftest_cli(tmp_path, served, capsys):
    """``--load --selftest`` rebuilds the live graph from the sidecar alone:
    blocks, out_hw, scales and flip (multi-scale + flip) differ from the
    CLI's defaults."""
    out = str(tmp_path / "m")
    ex.main(["--pretrained_ckpt_file", served[0], "--output", out, "--hw", "16,32",
             "--out_hw", "32,64", "--batch_size", "1", "--blocks", BLOCKS,
             "--compute_dtype", "float32", "--scales", "0.75,1.0", "--flip", "true",
             "--device", "cpu"])
    report = ex.main(["--load", out, "--selftest", "--pretrained_ckpt_file", served[0]])
    assert report["selftest"] == "OK" and report["input_shape"] == [1, 16, 32, 3]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == report


def test_export_bf16_embedded_params(tmp_path, served):
    """bf16 parameters embedded (the default under bf16 compute): bitwise the
    float32-embedded artifact's outputs, under 0.65 of its size; the fused
    kernel's BN vectors, the int8 scales and the heads' biases stay fp32."""
    out16, out32 = str(tmp_path / "m_bf16"), str(tmp_path / "m_fp32")
    meta16 = _export(served, out16)
    meta32 = _export(served, out32, "--embed_dtype", "float32")
    assert (meta16["compute_dtype"], meta16["embed_dtype"]) == ("bfloat16", "bfloat16")
    assert meta32["embed_dtype"] == "float32"
    assert os.path.getsize(out16 + ".pt2") < 0.65 * os.path.getsize(out32 + ".pt2")
    got = _run(out16, served[2])
    assert torch.equal(got, _run(out32, served[2]))
    assert ex.main(["--load", out16, "--selftest", "--pretrained_ckpt_file",
                    served[0]])["selftest"] == "OK"
    ep = torch.export.load(out16 + ".pt2")
    state = ep.state_dict
    fused = "model.layer3.1."
    assert state[fused + "bn2.scale"].dtype == torch.float32
    # one copy of the identity block's kernels: the packed ones, no conv weight
    assert not any(k.startswith(fused + "conv") for k in state)
    assert ep.constants[fused + "w2_hwio"].dtype == torch.bfloat16
    assert state["model.layer6.conv2d_list.0.bias"].dtype == torch.float32
    assert state["model.layer6.conv2d_list.0.weight"].dtype == torch.bfloat16
    assert state["model.layer3.0.bn2.scale"].dtype == torch.bfloat16  # not a fused block


def test_export_quantized_int8_artifact(tmp_path, served):
    """``--quantize int8``: the sidecar records the ranges, the selftest
    rebuilds the same int8 graph from them (exact), the artifact matches
    JAX's int8 serving function from those ranges, and stays close to the
    float artifact."""
    out = str(tmp_path / "mq")
    meta = _export(served, out, "--compute_dtype", "float32", "--quantize", "int8",
                   "--calib_images", served[1])
    assert meta["quantize"] == "int8"
    assert meta["calib_amax"] and all(v > 0 for v in meta["calib_amax"].values())
    got = _run(out, served[2])
    assert got.shape == (2, *HW) and got.dtype == torch.int32
    state = torch.export.load(out + ".pt2").state_dict  # a site holds its GEMM operand only
    assert state["model.layer3.1.conv2.w_mat"].dtype == torch.int8
    assert not any(k.endswith(".weight") and k.startswith("model.layer3") for k in state)
    assert ex.main(["--load", out, "--selftest", "--pretrained_ckpt_file",
                    served[0]])["selftest"] == "OK"
    want = _jax_serving(served, "float32", calib_amax=meta["calib_amax"])
    assert (got.numpy() == want).mean() >= 0.999
    cfg = ex._cfg({**meta, "numpy_transform": True, "pretrained_ckpt_file": served[0]})
    with torch.no_grad():
        fp = ex.make_serving_fn(cfg, ex._model(cfg, "cpu"), (1.0,), False, HW)(
            torch.from_numpy(served[2]))
    assert (fp == got).float().mean().item() > 0.9


@pytest.mark.parametrize("quantize", [False, True], ids=["float", "int8"])
def test_the_custom_op_traces_under_torch_export(served, quantize):
    """One ``msl.fused_bottleneck`` node a forward per identity block (the
    flip rides the same forward), none when those blocks are int8."""
    cfg = TrainConfig(blocks=tuple(int(b) for b in BLOCKS.split(",")), device="cpu",
                      pretrained_ckpt_file=served[0])
    model = ex._model(cfg, "cpu")
    if quantize:
        from maxsquareloss_torch.models.quantize import calibrate, quantize_params

        model = quantize_params(model, calibrate(model, cfg, [served[2]]))
    serve = ex.make_serving_fn(cfg, model, (0.75, 1.0), True, HW)
    with torch.no_grad():
        ep = torch.export.export(serve, (torch.from_numpy(served[2]),))
    ops = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert ops.count("msl.fused_bottleneck.default") == (0 if quantize else 2)


def test_export_sp_raises(tmp_path, served):
    """``--sp 2`` exports one space group of two processes (under
    ``torchrun``, ``tests/test_torch_spatial_export.py``): in one process
    it raises, and with ``--quantize int8`` it raises as the JAX tool does,
    both before the checkpoint is read."""
    argv = ["--pretrained_ckpt_file", served[0], "--output", str(tmp_path / "m"), *COMMON,
            "--sp", "2"]
    with pytest.raises(ValueError, match="run it as 2 processes"):
        ex.main(argv)
    with pytest.raises(ValueError, match="does not compose with --sp 2, as in the JAX tool"):
        ex.main([*argv, "--quantize", "int8", "--calib_images", served[1]])
    assert not os.path.exists(tmp_path / "m.json")
