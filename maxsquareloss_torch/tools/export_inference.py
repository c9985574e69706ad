"""Export the serving graph with ``torch.export`` (counterpart of
``tools/export_inference.py``, which writes StableHLO).

The single- or multi-scale (+flip) prediction function (uint8 NHWC batch
in, int32 trainId map out, normalization and TTA in the graph, the
parameters embedded) is exported at a static batch and resolution and
saved as ``<output>.pt2``, with a ``<output>.json`` sidecar of the JAX
tool's fields::

    # export (a .pth the trainers write)
    python -m maxsquareloss_torch.tools.export_inference \\
        --pretrained_ckpt_file runs/x/checkpoint_best.pth --output serve/model \\
        --hw 512,1024 --batch_size 16 [--scales 0.75,1.0,1.25 --flip true] \\
        [--quantize int8 --calib_images 'calib/*.png']

    # check an artifact: load it, run it, compare with the live graph rebuilt
    # from the sidecar (exact)
    python -m maxsquareloss_torch.tools.export_inference --load serve/model \\
        --selftest --pretrained_ckpt_file runs/x/checkpoint_best.pth

    # serve it
    import torch
    import maxsquareloss_torch.kernels.fused_block  # registers msl::fused_bottleneck
    fn = torch.export.load("serve/model.pt2").module()
    trainids = fn(uint8_batch_on_the_card)  # (N, H, W) int32, -1 = ignore

The one way the artifact differs from the JAX tool's, which loads with no
framework: the 29 identity blocks are the custom op
``torch.ops.msl.fused_bottleneck`` (``kernels/fused_block.py``), so the
process that loads the artifact imports ``maxsquareloss_torch.kernels.
fused_block`` to register it. On the card the op launches the
hand-written kernel (which it builds from ``csrc/`` on first use) or
raises; the exported graph never holds the plain version in its place.
An int8 artifact's identity blocks run their int8 convs one by one and
launch no fused kernel.

``--device`` (the card by default, ``cpu`` when asked) takes the place of
the JAX tool's ``--platforms``: an artifact runs on the device it was
exported on. ``--embed_dtype compute`` (the default) stores the
parameters in bf16 under ``--compute_dtype bfloat16`` wherever the graph
casts them to the activation's dtype at their one use, so the outputs are
bitwise those of float32 storage; the int8 scales, the fused kernel's BN
vectors (which it applies in float32) and the heads' biases (which the
eval form adds in float32) stay float32. ``--sp > 1`` raises: a sharded
artifact waits on ROADMAP Queue 1 item 2, sub-step (c) (``tools.evaluate``,
``tools.predict`` and the trainers take ``--sp``).
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import torch
from torch import nn

import maxsquareloss_torch.kernels.fused_block  # noqa: F401  (registers msl::fused_bottleneck)
from maxsquareloss_torch.config import TrainConfig, str2bool
from maxsquareloss_torch.models.layers import QConv2d
from maxsquareloss_torch.predict import predict_core
from maxsquareloss_torch.utils.device import resolve_device


class ServingModule(nn.Module):
    """The serving function as a module (``torch.export`` lifts the model's
    parameters and buffers): ``forward(x)`` is ``predict``'s function on a
    uint8 (N, H, W, 3) batch."""

    def __init__(self, cfg: TrainConfig, model: nn.Module, scales, flip: bool, out_hw):
        super().__init__()
        self.model = model
        self.fn = predict_core(cfg, model, scales, flip, out_hw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)


def make_serving_fn(cfg: TrainConfig, model: nn.Module, scales, flip: bool, out_hw):
    """uint8 NHWC batch → int32 trainIds (``make_serving_fn`` of the JAX
    tool): normalization (``cfg.numpy_transform``: caffe or torchvision)
    and TTA in the graph."""
    return ServingModule(cfg, model, scales, flip, out_hw).eval()


def _kept_float32(model: nn.Module) -> set[int]:
    """The tensors ``embed_cast`` keeps in float32, by id: the int8 sites'
    scales, the BN vectors of the blocks the fused kernel runs, the heads'
    biases."""
    keep = set()
    for m in model.modules():
        if isinstance(m, QConv2d):
            keep |= {id(m.oscale), id(m.ascale_inv)}
        if getattr(m, "fusable", False) and not m.quantized:
            keep |= {id(t) for bn in (m.bn1, m.bn2, m.bn3) for t in (bn.scale, bn.bias)}
    for head in ("layer5", "layer6"):
        if hasattr(model, head):
            keep |= {id(c.bias) for c in getattr(model, head).conv2d_list}
    return keep


@torch.no_grad()
def embed_cast(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Store the float32 parameters and buffers in ``dtype`` (bf16), in
    place, where the graph casts them to the activation's dtype at their one
    use: bitwise the same outputs, half their bytes. What the graph reads
    in float32 stays float32 (``_kept_float32``)."""
    keep = _kept_float32(model)
    for t in list(model.parameters()) + list(model.buffers()):
        if t.dtype == torch.float32 and id(t) not in keep:
            t.data = t.data.to(dtype)
    return model


def _model(cfg: TrainConfig, device, calib_amax=None):
    """The checkpoint's model with the heads' eval form; int8 from
    ``calib_amax`` when given."""
    from maxsquareloss_torch.tools.common import load_inference_model

    model = load_inference_model(cfg, device)
    if calib_amax is not None:
        from maxsquareloss_torch.models.quantize import quantize_params

        model = quantize_params(model, calib_amax)
    return model


def _calib_batches(pattern: str, hw: tuple[int, int]):
    """uint8 batches of one image each: the first 16 files matching
    ``pattern``, resized to ``hw`` (bicubic), as the JAX tool reads them."""
    from PIL import Image

    files = sorted(glob.glob(pattern))
    for fp in files[:16]:
        pil = Image.open(fp).convert("RGB")
        if pil.size != (hw[1], hw[0]):
            pil = pil.resize((hw[1], hw[0]), Image.BICUBIC)
        yield np.array(pil, np.uint8)[None]


def _cfg(meta_or_args: dict) -> TrainConfig:
    return TrainConfig(
        num_classes=meta_or_args["num_classes"], multi=meta_or_args["multi"],
        blocks=tuple(meta_or_args["blocks"]), compute_dtype=meta_or_args["compute_dtype"],
        numpy_transform=meta_or_args["numpy_transform"], device_normalize=True,
        pretrained_ckpt_file=meta_or_args["pretrained_ckpt_file"], data_parallel=False,
        device=meta_or_args["device"],
    )


def selftest(base: str, ckpt: str) -> dict:
    """Load ``<base>.pt2``, run it on a seeded uint8 batch, and compare it
    with the live graph rebuilt from the sidecar and ``ckpt`` (exact);
    the report carries the fused kernel's launches in the artifact's
    forward and in the live one."""
    from maxsquareloss_torch.kernels.fused_block import fused_bottleneck

    meta = json.load(open(base + ".json"))
    cfg = _cfg({**meta, "numpy_transform": meta["normalization"] == "caffe BGR-mean",
                "pretrained_ckpt_file": ckpt})
    device = resolve_device(cfg.device)
    art = torch.export.load(base + ".pt2").module()
    model = _model(cfg, device, meta.get("calib_amax"))
    model.drop_fused_conv_weights()
    serve = make_serving_fn(cfg, model, tuple(meta["scales"]), meta["flip"],
                            tuple(meta["out_hw"]))
    x = np.random.default_rng(0).integers(0, 256, size=tuple(meta["input_shape"]))
    x = torch.from_numpy(x.astype(np.uint8)).to(device)
    with torch.no_grad():
        before = fused_bottleneck.launches
        got = art(x)
        art_launches = fused_bottleneck.launches - before
        want = serve(x)
        live_launches = fused_bottleneck.launches - before - art_launches
    equal = bool(torch.equal(got, want))
    report = {"selftest": "OK" if equal else "MISMATCH", "input_shape": meta["input_shape"],
              "equal_share": (got == want).float().mean().item(), "device": str(device),
              "artifact_kernel_launches": art_launches, "live_kernel_launches": live_launches}
    print(json.dumps(report), flush=True)
    if not equal:
        raise AssertionError(f"artifact != live graph: {report}")
    return report


def export(args, cfg: TrainConfig) -> dict:
    """Build, export and save the artifact and its sidecar; the sidecar."""
    h, w = (int(v) for v in args.hw.split(","))
    oh, ow = (int(v) for v in (args.out_hw or args.hw).split(","))
    scales = tuple(float(s) for s in args.scales.split(","))
    device = resolve_device(cfg.device)
    model = _model(cfg, device)
    quant_amax = None
    if args.quantize == "int8":
        from maxsquareloss_torch.models.quantize import calibrate, quantize_params

        if not glob.glob(args.calib_images):
            raise ValueError("--quantize int8 needs --calib_images matching >=1 file")
        quant_amax = calibrate(model, cfg, _calib_batches(args.calib_images, (h, w)))
        model = quantize_params(model, quant_amax)
        print(f"int8 PTQ: calibrated {len(quant_amax)} conv sites on "
              f"{min(len(glob.glob(args.calib_images)), 16)} images; backbone convs now int8")
    # one copy of each kernel in the artifact: the float identity blocks keep
    # only their packed copies (an int8 site holds only its GEMM operand)
    model.drop_fused_conv_weights()
    embedded = "float32"
    if args.embed_dtype == "compute" and args.compute_dtype == "bfloat16":
        embed_cast(model, torch.bfloat16)
        embedded = "bfloat16"
    serve = make_serving_fn(cfg, model, scales, args.flip, (oh, ow))
    x = torch.zeros((args.batch_size, h, w, 3), dtype=torch.uint8, device=device)
    with torch.no_grad():
        ep = torch.export.export(serve, (x,))
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    torch.export.save(ep, args.output + ".pt2")
    meta = {
        "input_shape": list(x.shape), "input_dtype": "uint8",
        "output": "int32 trainIds (N, out_h, out_w); -1 = ignore",
        "out_hw": [oh, ow], "num_classes": cfg.num_classes, "multi": cfg.multi,
        "blocks": list(cfg.blocks),
        "normalization": "caffe BGR-mean" if cfg.numpy_transform else "torchvision mean/std",
        "compute_dtype": args.compute_dtype, "embed_dtype": embedded,
        "scales": list(scales), "flip": args.flip, "device": str(device), "sp": 1,
        "quantize": args.quantize,
        **({"calib_amax": quant_amax} if quant_amax is not None else {}),
        "consume": ("import maxsquareloss_torch.kernels.fused_block; "
                    "torch.export.load(path).module()(uint8_batch) on the device above"),
    }
    with open(args.output + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    size = os.path.getsize(args.output + ".pt2")
    print(f"wrote {args.output}.pt2 ({size / 1e6:.1f} MB, {device}) + {args.output}.json")
    return meta


def main(argv=None):
    p = argparse.ArgumentParser("export_inference")
    p.add_argument("--pretrained_ckpt_file", default=None, help="a .pth the trainers write")
    p.add_argument("--output", default=None, help="artifact basename: <output>.pt2 + .json")
    p.add_argument("--load", default=None, help="check an existing artifact basename instead")
    p.add_argument("--selftest", action="store_true",
                   help="with --load: run the artifact on a seeded batch and compare it "
                        "exactly with the live graph rebuilt from the sidecar")
    p.add_argument("--hw", default="512,1024", help="input H,W (static)")
    p.add_argument("--out_hw", default=None, help="output label H,W (default = --hw)")
    p.add_argument("--batch_size", type=int, default=16, help="static serving batch")
    p.add_argument("--num_classes", type=int, default=19)
    p.add_argument("--multi", type=str2bool, default=True)
    p.add_argument("--blocks", default="3,4,23,3")
    p.add_argument("--compute_dtype", default="bfloat16", choices=("float32", "bfloat16"))
    p.add_argument("--numpy_transform", type=str2bool, default=True)
    p.add_argument("--scales", default="1.0")
    p.add_argument("--flip", type=str2bool, default=False)
    p.add_argument("--device", default=None,
                   help="torch device of the artifact (default: the card; 'cpu' exports "
                        "the plain PyTorch versions of the kernels)")
    p.add_argument("--embed_dtype", default="compute", choices=("compute", "float32"),
                   help="'compute' stores bf16 parameters under --compute_dtype bfloat16 "
                        "(bitwise the same outputs); 'float32' keeps them float32")
    p.add_argument("--quantize", default="", choices=("", "int8"),
                   help="post-training int8 backbone convs (heads stay float); needs "
                        "--calib_images, whose ranges the sidecar records")
    p.add_argument("--calib_images", default="",
                   help="glob of calibration images for --quantize int8 (resized to --hw; "
                        "the first 16 matches)")
    p.add_argument("--sp", type=int, default=1,
                   help="spatial partitioning of the artifact (not ported; evaluate, "
                        "predict and the trainers take --sp)")
    args = p.parse_args(argv)
    if args.sp > 1:
        raise NotImplementedError(
            f"--sp {args.sp} is not ported for the export: a sharded artifact waits on ROADMAP "
            "Queue 1 item 2 (spatial partitioning, sub-step (c)); tools.evaluate, "
            "tools.predict and the trainers take --sp")
    if args.load:
        if not args.selftest:
            meta = json.load(open(args.load + ".json"))
            print(f"{args.load}.pt2: in={meta['input_shape']} out_hw={meta['out_hw']} "
                  f"device={meta['device']}")
            return meta
        if not args.pretrained_ckpt_file:
            p.error("--selftest needs --pretrained_ckpt_file to rebuild the live graph")
        return selftest(args.load, args.pretrained_ckpt_file)
    if not (args.pretrained_ckpt_file and args.output):
        p.error("--pretrained_ckpt_file and --output are required for export")
    cfg = _cfg({**vars(args), "blocks": [int(v) for v in args.blocks.split(",")]})
    return export(args, cfg)


if __name__ == "__main__":
    main()
