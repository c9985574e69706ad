"""Configuration of the port and its reference-flag argparse shims (the
port's own copy of ``maxsquareloss_tpu/config.py``).

``TrainConfig`` has every field of the JAX package's, under the same names
and defaults, plus ``device`` (``None``: the card). ``add_train_args``,
``add_uda_train_args`` and ``config_from_args`` keep flag-for-flag parity
with the JAX CLIs. The paths compute in ``--compute_dtype`` (float32 or
bfloat16; parameters, optimizer and checkpoints float32), one process per card
(``parallel/``: ``torchrun``, or the JAX CLIs' ``--coordinator_address
--num_processes --process_id``); batch sizes are global. A flag for
something the port does not have yet raises in ``check_supported`` with the
ROADMAP item it waits on, instead of being ignored. ``--sp N`` (spatial
partitioning, ``parallel/spatial.py``) is ported for the serving CLIs, the
export and the trainers, with every training option.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Any

import torch

TARGET_MODES = ("maxsquare", "IW_maxsquare", "entropy", "IW_entropy", "hard")
DATASETS = ("cityscapes", "gta5", "synthia", "crosscity")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # model
    num_classes: int = 19
    backbone: str = "deeplabv2_multi"
    blocks: tuple[int, ...] = (3, 4, 23, 3)  # ResNet-101; tests shrink this
    multi: bool = True                 # multi-level (aux head layer5)
    freeze_bn: bool = True             # BN is always frozen (folded buffers)
    compute_dtype: str = "float32"     # 'float32' | 'bfloat16' (activations only)
    remat: str = ""                    # '' | 'stages': recompute each ResNet stage
    xla_options: str = "auto"          # the JAX package's compiler knob; none here
    concat_batches: bool = False       # UDA: one masked-canvas forward for both batches

    # optimizer (reference defaults: SGD 2.5e-4, momentum .9, wd 5e-4)
    lr: float = 2.5e-4
    momentum: float = 0.9
    weight_decay: float = 5e-4
    iter_max: int = 200000
    iter_stop: int | None = None
    poly_power: float = 0.9

    # supervised / source loss: the aux head's CE weight
    lambda_seg: float = 0.1

    # UDA target loss
    # 'maxsquare' | 'IW_maxsquare' | 'entropy' | 'IW_entropy' | 'hard'
    target_mode: str = "IW_maxsquare"
    lambda_target: float = 0.09
    ratio: float = 0.2                 # --IW_ratio
    threshold: float = 0.95            # guidance confidence threshold
    guidance_mask: str = "ensemble"    # 'ensemble' | 'per_head_or'
    # histogram of the IW weights under --multi: 'guidance' counts the
    # thresholded pseudo-label (reference parity; a class none of whose
    # pixels clears --threshold gets the degenerate weight 1.0), 'argmax'
    # the unthresholded prediction (the single-head behaviour)
    iw_hist: str = "guidance"          # 'guidance' | 'argmax'

    # data: (W, H) sizes as in the reference flags
    batch_size: int = 4
    eval_batch_size: int = 0           # validation batch (0 = batch_size)
    dataset: str = "gta5"
    base_size: tuple[int, int] = (1280, 720)
    crop_size: tuple[int, int] = (1280, 640)
    target_base_size: tuple[int, int] = (1024, 512)
    target_crop_size: tuple[int, int] = (1024, 512)
    num_workers: int = 8
    loader: str = "threads"            # 'threads' | 'grain' (needs the grain package)
    # ship uint8 images / int8 labels and normalize on the device
    device_normalize: bool = False
    cache_dir: str | None = None       # decoded-sample cache (base-size npz)
    random_mirror: bool = True
    random_crop: bool = False
    gaussian_blur: bool = True
    numpy_transform: bool = True       # caffe BGR − IMG_MEAN (protocol default)
    class_16: bool = False
    class_13: bool = False

    # runtime
    seed: int = 0
    checkpoint_dir: str = "./runs/default"
    pretrained_ckpt_file: str | None = None
    continue_training: bool = False
    epoch_num: int = 100
    save_iter: int | None = None       # also checkpoint every N iterations
    tqdm: bool = True                  # progress bars (when tqdm is installed)
    validation_epoch: int = 1
    show_num_images: int = 3
    # shard the global batch over the processes; false with several
    # processes raises (each would train a model of its own)
    data_parallel: bool = True
    sp: int = 1                        # spatial partitioning: ranks a space group
    # stream the eval upsample→softmax→argmax→CM tail over N output rows at
    # a time (exact: row-local interpolation); -1 = auto (256-row chunks
    # whenever the label height exceeds 512), 0 = off
    eval_h_chunk: int = -1
    quantize: str = ""                 # '' | 'int8': PTQ for evaluation and serving
    calib_batches: int = 4
    calib_mode: str = "amax"
    profile: bool = False              # torch.profiler trace of iterations 2-5
    debug_nans: bool = False           # anomaly mode; a non-finite loss raises
    # graceful preemption: on SIGTERM, finish the in-flight step, write a
    # mid-epoch checkpoint (carrying the exact batch offset) and return
    preempt_save: bool = True
    preempt_sync_steps: int = 10       # several processes: decide together every N steps
    compilation_cache_dir: str = "auto"  # the JAX package's compile cache; none here

    # several processes without torchrun: tcp://<address>, world size, rank
    coordinator_address: str | None = None
    num_processes: int | None = None
    process_id: int | None = None

    # the torch device of the run: None = the card (raises without one)
    device: str | None = None

    def effective_iter_stop(self) -> int:
        return self.iter_stop if self.iter_stop is not None else self.iter_max

    @property
    def dtype(self) -> torch.dtype:
        """The torch dtype of ``compute_dtype``."""
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32


# (field, value that is fine, why not) for every option the port lacks
_UNPORTED = (
    ("freeze_bn", True, "--freeze_bn false: BN is always frozen (folded into buffers), "
     "as in the JAX package"),
)


def check_supported(cfg: TrainConfig) -> None:
    """Raise on an option the port does not have: never ignore it. With
    several processes ``--sp`` must divide their number."""
    for name, ok, why in _UNPORTED:
        if getattr(cfg, name) != ok:
            what = f"{name}={getattr(cfg, name)!r}" + (f" with sp={cfg.sp}" if cfg.sp > 1 else "")
            raise NotImplementedError(f"{what} is not ported: {why}")
    from maxsquareloss_torch.parallel.ddp import world
    from maxsquareloss_torch.parallel.multihost import launched_world

    # before the group exists, the launcher's or the flags' count
    procs = max(world(), launched_world(cfg.num_processes))
    if procs % cfg.sp:
        raise ValueError(f"--sp {cfg.sp} does not divide the {procs} process(es): run a "
                         f"multiple of {cfg.sp} processes (one space group each)")
    if not cfg.data_parallel:
        # --sp N with --data_parallel false is one space group: the JAX
        # package's (1, sp) mesh
        if world() > cfg.sp:
            # the JAX package's processes then each jit a step of their own
            # on their shard and never sync: that trains world models, not one
            raise ValueError(f"--data_parallel false with {world()} processes would train "
                             f"{world()} unrelated models; run one process or drop the flag")
    for name in ("xla_options", "compilation_cache_dir"):
        if getattr(cfg, name) not in ("auto", ""):
            raise NotImplementedError(
                f"--{name} configures XLA, which the port does not use")


def _size(s: str | tuple) -> tuple[int, int]:
    if isinstance(s, tuple):
        return s
    w, h = (int(v) for v in s.split(","))
    return (w, h)


def add_train_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """Shared training flags (the JAX package's ``add_train_args``), plus
    ``--device``."""
    p.add_argument("--dataset", default="gta5", choices=DATASETS)
    p.add_argument("--data_root_path", default="./datasets")
    p.add_argument("--list_path", default=None,
                   help="split list file; defaults to <root>/<split>.txt")
    p.add_argument("--checkpoint_dir", default="./runs/default")
    p.add_argument("--train_id", default=None,
                   help="experiment tag appended to --checkpoint_dir; 'auto' "
                        "derives '<dataset>_<backbone>[_<target_mode>]'")
    p.add_argument("--pretrained_ckpt_file", default=None)
    p.add_argument("--continue_training", action="store_true")
    p.add_argument("--backbone", default="deeplabv2_multi")
    p.add_argument("--blocks", default="3,4,23,3",
                   help="ResNet stage depths (default R101; smaller values "
                        "for CI/smoke runs, e.g. '2,2,2,2')")
    p.add_argument("--num_classes", type=int, default=19)
    p.add_argument("--multi", type=str2bool, default=True)
    p.add_argument("--freeze_bn", type=str2bool, default=True)
    p.add_argument("--lr", type=float, default=2.5e-4)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight_decay", type=float, default=5e-4)
    p.add_argument("--iter_max", type=int, default=200000)
    p.add_argument("--iter_stop", type=int, default=None)
    p.add_argument("--poly_power", type=float, default=0.9)
    p.add_argument("--lambda_seg", type=float, default=0.1)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--eval_batch_size", type=int, default=0,
                   help="validation batch (0 = same as --batch_size)")
    p.add_argument("--base_size", default="1280,720")
    p.add_argument("--crop_size", default="1280,640")
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--loader", default="threads", choices=("threads", "grain"))
    p.add_argument("--cache_dir", default=None,
                   help="decoded-sample cache dir (skips PNG decode + base resize)")
    p.add_argument("--device_normalize", type=str2bool, default=False,
                   help="ship uint8 images/int8 labels and normalize on the device")
    p.add_argument("--random_mirror", type=str2bool, default=True)
    p.add_argument("--random_crop", type=str2bool, default=False)
    p.add_argument("--gaussian_blur", type=str2bool, default=True)
    p.add_argument("--numpy_transform", type=str2bool, default=True)
    p.add_argument("--class_16", type=str2bool, default=False)
    p.add_argument("--class_13", type=str2bool, default=False)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--epoch_num", type=int, default=100)
    p.add_argument("--save_iter", type=int, default=None,
                   help="also checkpoint every N iterations (mid-epoch)")
    p.add_argument("--validation_epoch", type=int, default=1)
    p.add_argument("--show_num_images", type=int, default=3)
    p.add_argument("--compute_dtype", default="float32", choices=("float32", "bfloat16"))
    p.add_argument("--remat", default="", choices=("", "stages"))
    p.add_argument("--concat_batches", type=str2bool, default=False)
    p.add_argument("--tqdm", type=str2bool, default=True)
    p.add_argument("--xla_options", default="auto")
    p.add_argument("--data_parallel", type=str2bool, default=True)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--eval_h_chunk", type=int, default=-1,
                   help="stream eval upsample/argmax/CM over N output rows "
                        "at a time (exact). -1 = auto (256 when label height > 512), 0 = off")
    p.add_argument("--profile", action="store_true")
    p.add_argument("--debug_nans", action="store_true")
    p.add_argument("--quantize", default="", choices=("", "int8"))
    p.add_argument("--calib_batches", type=int, default=4)
    p.add_argument("--calib_mode", default="amax")
    p.add_argument("--preempt_save", type=str2bool, default=True,
                   help="on SIGTERM: checkpoint at the next step boundary "
                        "and return (resume with --continue_training)")
    p.add_argument("--preempt_sync_steps", type=int, default=10)
    p.add_argument("--compilation_cache_dir", default="auto")
    p.add_argument("--coordinator_address", default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the plain "
                        "PyTorch versions of the kernels on the host)")
    return p


def add_uda_train_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """UDA flags (the JAX package's ``add_uda_train_args``)."""
    p.add_argument("--source_dataset", default="gta5", choices=("gta5", "synthia"))
    p.add_argument("--source_data_path", default=None)
    p.add_argument("--source_list_path", default=None)
    p.add_argument("--target_data_path", default=None)
    p.add_argument("--target_list_path", default=None)
    p.add_argument("--target_mode", default="IW_maxsquare", choices=TARGET_MODES)
    p.add_argument("--lambda_target", type=float, default=0.09)
    p.add_argument("--IW_ratio", type=float, default=0.2)
    p.add_argument("--threshold", type=float, default=0.95)
    p.add_argument("--guidance_mask", default="ensemble", choices=("ensemble", "per_head_or"))
    p.add_argument("--iw_hist", default="guidance", choices=("guidance", "argmax"))
    p.add_argument("--target_base_size", default="1024,512")
    p.add_argument("--target_crop_size", default="1024,512")
    return p


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("1", "true", "yes", "y", "t")


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    """The parsed namespace → a checked TrainConfig; makes the run dir."""
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    kv: dict[str, Any] = {}
    for k, v in vars(args).items():
        if k == "IW_ratio":
            kv["ratio"] = v
        elif k in fields:
            kv[k] = v
    for k in ("base_size", "crop_size", "target_base_size", "target_crop_size"):
        if k in kv and kv[k] is not None:
            kv[k] = _size(kv[k])
    if isinstance(kv.get("blocks"), str):
        kv["blocks"] = tuple(int(v) for v in kv["blocks"].split(","))
    train_id = getattr(args, "train_id", None)
    if train_id:
        if train_id == "auto":
            parts = [kv.get("dataset", "gta5"), kv.get("backbone", "deeplabv2_multi")]
            if getattr(args, "target_mode", None):
                parts.append(args.target_mode)
            train_id = "_".join(parts)
        kv["checkpoint_dir"] = os.path.join(kv.get("checkpoint_dir", "./runs/default"), train_id)
    cfg = TrainConfig(**kv)
    if cfg.eval_batch_size < 0:
        raise ValueError(
            f"--eval_batch_size must be >= 0 (0 = same as --batch_size), got {cfg.eval_batch_size}"
        )
    if cfg.sp < 1:
        raise ValueError(f"--sp must be >= 1, got {cfg.sp}")
    if cfg.sp > 1:
        # the JAX package's checks, flag for flag: the heights it shards
        # must split evenly over its 'space' axis, and its partitioner cannot
        # pad int8 halos
        for name in ("crop_size", "target_crop_size", "base_size"):
            wh = getattr(cfg, name)
            if wh and wh[1] % cfg.sp:
                raise ValueError(f"--sp {cfg.sp} must divide the image height: {name} H = "
                                 f"{wh[1]}")
        if cfg.quantize:
            raise ValueError(f"--quantize {cfg.quantize} does not compose with --sp {cfg.sp}, "
                             "as in the JAX package: use --sp for float serving, or int8 with "
                             "data parallelism")
    check_supported(cfg)
    os.makedirs(cfg.checkpoint_dir, exist_ok=True)
    return cfg
