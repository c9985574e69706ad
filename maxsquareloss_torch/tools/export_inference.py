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

    # a sharded artifact (the JAX tool's --sp, "batch-1 full-res requests"):
    # one graph per rank of a space group of N, exported and checked under
    # torchrun (gloo with --device cpu, NCCL on the cards)
    torchrun --nproc_per_node 2 -m maxsquareloss_torch.tools.export_inference \
        --pretrained_ckpt_file runs/x/checkpoint_best.pth --output serve/sp2 \
        --hw 1024,2048 --batch_size 1 --sp 2
    torchrun --nproc_per_node 2 -m maxsquareloss_torch.tools.export_inference \
        --load serve/sp2 --selftest --pretrained_ckpt_file runs/x/checkpoint_best.pth

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
eval form adds in float32) stay float32.

``--sp N`` (spatial partitioning, ``parallel/spatial.py``): the image rows
split over a space group of N processes, as the JAX tool's (1, sp) mesh.
A rank's windows depend on its index (border padding, uneven shards), so
each rank of the ``torchrun`` launch exports its own graph,
``<output>.rank<r>.pt2``: it takes rows ``input_rows[r]`` (the sidecar's)
of the uint8 batch and returns the whole (N, out_h, out_w) map, as the JAX
artifact returns it replicated on every device. The row exchanges are the
custom ops ``msl::sp_fetch_rows`` and ``msl::sp_all_rows``, chained so that
every exchange stays in the graph in one order on every rank; the process
that loads an artifact joins a space group of N (``spatial.space_group``,
on the backend it chooses: the artifact records none) and imports
``maxsquareloss_torch.parallel.spatial`` to register them. int8 does not
compose with ``--sp``, and ``--sp`` must divide the input height: both
raise before any checkpoint is loaded.
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
from maxsquareloss_torch.parallel import ddp, multihost, spatial
from maxsquareloss_torch.parallel.spatial import SpaceGroup
from maxsquareloss_torch.predict import predict_core
from maxsquareloss_torch.utils.device import resolve_device


class ServingModule(nn.Module):
    """The serving function as a module (``torch.export`` lifts the model's
    parameters and buffers): ``forward(x)`` is ``predict``'s function on a
    uint8 (N, H, W, 3) batch. ``space``: ``x`` is this rank's rows of
    images of ``in_h`` rows, and every rank returns the whole map."""

    def __init__(self, cfg: TrainConfig, model: nn.Module, scales, flip: bool, out_hw,
                 space: SpaceGroup | None = None, in_h: int | None = None):
        super().__init__()
        self.model = model
        self.fn = predict_core(cfg, model, scales, flip, out_hw, space)
        self.space, self.in_h, self.out_h = space, in_h, out_hw[0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.space is None:
            return self.fn(x)
        with spatial.serving(self.space):
            return spatial.all_rows(self.fn(x, self.in_h), self.out_h, self.space)


def make_serving_fn(cfg: TrainConfig, model: nn.Module, scales, flip: bool, out_hw,
                    space: SpaceGroup | None = None, in_h: int | None = None):
    """uint8 NHWC batch → int32 trainIds (``make_serving_fn`` of the JAX
    tool): normalization (``cfg.numpy_transform``: caffe or torchvision)
    and TTA in the graph; ``space``: on this rank's rows (``ServingModule``)."""
    return ServingModule(cfg, model, scales, flip, out_hw, space, in_h).eval()


def _space(sp: int, device) -> SpaceGroup | None:
    """The space group of ``--sp sp`` (None for 1): this process must be one
    of exactly ``sp`` (``torchrun --nproc_per_node sp``)."""
    if sp <= 1:
        return None
    multihost.initialize_distributed(device)
    if ddp.world() != sp:
        raise ValueError(f"--sp {sp} exports one space group: run it as {sp} processes "
                         f"(torchrun --nproc_per_node {sp}), not {ddp.world()}")
    return spatial.space_group(sp)


def _rank_file(base: str, rank: int) -> str:
    return f"{base}.rank{rank}.pt2"


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
    """Load ``<base>.pt2`` (under ``--sp``: this rank's file), run it on a
    seeded uint8 batch (this rank's rows of it), and compare it with the
    live graph rebuilt from the sidecar and ``ckpt`` (exact); the report
    carries the fused kernel's launches in the artifact's forward and in the
    live one (under ``--sp``: every rank's, printed by rank 0)."""
    from maxsquareloss_torch.kernels.fused_block import fused_bottleneck

    meta = json.load(open(base + ".json"))
    cfg = _cfg({**meta, "numpy_transform": meta["normalization"] == "caffe BGR-mean",
                "pretrained_ckpt_file": ckpt})
    device = resolve_device(cfg.device)
    space = _space(meta.get("sp", 1), device)
    rank = 0 if space is None else space.index
    path = base + ".pt2" if space is None else os.path.join(
        os.path.dirname(os.path.abspath(base)), meta["files"][rank])
    art = torch.export.load(path).module()
    model = _model(cfg, device, meta.get("calib_amax"))
    model.drop_fused_conv_weights()
    h = meta["input_shape"][1]
    serve = make_serving_fn(cfg, model, tuple(meta["scales"]), meta["flip"],
                            tuple(meta["out_hw"]), space, h)
    x = np.random.default_rng(0).integers(0, 256, size=tuple(meta["input_shape"]))
    if space is not None:
        x = x[:, slice(*meta["input_rows"][rank])]
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
    if space is not None:
        ranks = ddp.all_gather(torch.tensor([int(equal), art_launches, live_launches]))
        equal = bool(ranks[:, 0].all())
        report.update(selftest="OK" if equal else "MISMATCH", sp=space.sp, rank=rank,
                      output_shape=list(got.shape),
                      rank_equal=[bool(v) for v in ranks[:, 0]],
                      rank_artifact_kernel_launches=ranks[:, 1].tolist(),
                      rank_live_kernel_launches=ranks[:, 2].tolist())
    if rank == 0:
        print(json.dumps(report), flush=True)
    if not equal:
        raise AssertionError(f"artifact != live graph: {report}")
    return report


def export(args, cfg: TrainConfig) -> dict:
    """Build, export and save the artifact and its sidecar; the sidecar.
    Under ``--sp`` each rank writes its graph and rank 0 the sidecar."""
    h, w = (int(v) for v in args.hw.split(","))
    oh, ow = (int(v) for v in (args.out_hw or args.hw).split(","))
    scales = tuple(float(s) for s in args.scales.split(","))
    device = resolve_device(cfg.device)
    space = _space(args.sp, device)
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
    serve = make_serving_fn(cfg, model, scales, args.flip, (oh, ow), space, h)
    rows = [(0, h)] if space is None else space.split(h)
    rank = 0 if space is None else space.index
    x = torch.zeros((args.batch_size, rows[rank][1] - rows[rank][0], w, 3), dtype=torch.uint8,
                    device=device)
    with torch.no_grad():
        ep = torch.export.export(serve, (x,))
    path = args.output + ".pt2" if space is None else _rank_file(args.output, rank)
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    torch.export.save(ep, path)
    meta = {
        "input_shape": [args.batch_size, h, w, 3], "input_dtype": "uint8",
        "output": "int32 trainIds (N, out_h, out_w); -1 = ignore",
        "out_hw": [oh, ow], "num_classes": cfg.num_classes, "multi": cfg.multi,
        "blocks": list(cfg.blocks),
        "normalization": "caffe BGR-mean" if cfg.numpy_transform else "torchvision mean/std",
        "compute_dtype": args.compute_dtype, "embed_dtype": embedded,
        "scales": list(scales), "flip": args.flip, "sp": args.sp,
        # under --sp every rank's card, as --device names it (none: each rank's own)
        "device": str(device) if space is None else (args.device or device.type),
        "quantize": args.quantize,
        **({"calib_amax": quant_amax} if quant_amax is not None else {}),
        "consume": ("import maxsquareloss_torch.kernels.fused_block; "
                    "torch.export.load(path).module()(uint8_batch) on the device above"),
    }
    if space is not None:
        meta.update(
            files=[os.path.basename(_rank_file(args.output, r)) for r in range(space.sp)],
            input_rows=[list(r) for r in rows],
            consume=(f"{space.sp} processes (torchrun --nproc_per_node {space.sp}), one space "
                     "group: torch.distributed.init_process_group(backend), then "
                     f"maxsquareloss_torch.parallel.spatial.space_group({space.sp}); import "
                     "maxsquareloss_torch.kernels.fused_block and maxsquareloss_torch.parallel."
                     "spatial; rank r runs torch.export.load(files[r]).module() on rows "
                     "input_rows[r] of the uint8 batch, on the device above (its card under "
                     "NCCL), and gets the whole map"))
    if rank == 0:
        with open(args.output + ".json", "w") as f:
            json.dump(meta, f, indent=1)
    sizes = [os.path.getsize(path)]
    if space is not None:  # every rank returns once every file and the sidecar are written
        sizes = ddp.all_gather(torch.tensor(sizes[0])).tolist()
    if rank == 0:
        files = path if space is None else f"{args.output}.rank{{0..{space.sp - 1}}}.pt2"
        print(f"wrote {files} ({', '.join(f'{b / 1e6:.1f}' for b in sizes)} MB, {device}) + "
              f"{args.output}.json")
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
                   help="spatial partitioning: the image rows split over a space group of "
                        "this many processes (torchrun --nproc_per_node N), each exporting "
                        "<output>.rank<r>.pt2 for its rows; every rank's graph returns the "
                        "whole map. 1 = off")
    args = p.parse_args(argv)
    if args.sp < 1:
        raise ValueError(f"--sp must be >= 1, got {args.sp}")
    if args.sp > 1 and not args.load:
        # before the checkpoint and the calibration, as the JAX tool
        if args.quantize:
            raise ValueError(f"--quantize {args.quantize} does not compose with --sp "
                             f"{args.sp}, as in the JAX tool")
        if int(args.hw.split(",")[0]) % args.sp:
            raise ValueError(f"--sp {args.sp} must divide the input height {args.hw}")
    if args.load:
        if not args.selftest:
            meta = json.load(open(args.load + ".json"))
            print(f"{args.load}: {meta.get('files', 'one .pt2')} in={meta['input_shape']} "
                  f"out_hw={meta['out_hw']} sp={meta['sp']} device={meta['device']}")
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
    ddp.shutdown()
