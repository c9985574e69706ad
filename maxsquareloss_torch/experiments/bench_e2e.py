"""End-to-end disk → loader → device UDA training throughput (counterpart of
``experiments/bench_e2e.py``), the ``e2e`` mode of ``maxsquareloss_torch.bench``.

The step-rate modes of the bench leave out the host pipeline. This one runs
the whole path at the protocol's shapes:

  GTA5-size source PNGs (1914x1052) → decode → resize to base 1280x720 →
  augment → uint8, Cityscapes-size target PNGs (2048x1024) → base 1024x512,
  ``SegDataLoader`` worker threads → ``device_prefetch`` → UDA train step.

Rates (images/s, source and target images counted):
  e2e_cold          no decoded-sample cache: every epoch decodes and resizes
  e2e_warm          the ``cache_dir`` base-size cache, primed by the leg's
                    first epoch
  e2e_prepared      ``tools/prepare_dataset.py`` PNGs at base size
  e2e_prepared_raw  its ``--format raw`` ``.npy`` sidecars: no PNG decode
  device_only       the same step on device-resident batches (the ceiling)

Each leg runs one priming epoch, then ``--epochs`` timed ones (median
reported); an epoch is fenced by ``torch.cuda.synchronize()`` and a host
read of the last loss. ``h2d_MB_per_sec`` times pinned host → card copies
(``null`` on the CPU). Under ``torchrun`` each process loads its shard of
every global batch and the steps run under DDP; rank 0 writes the dataset
and the prepared roots while the others wait, and the rates are rank 0's
images a second, a rate per chip.

    python -m maxsquareloss_torch.bench --mode e2e [--data_root DIR --num_workers N]
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from maxsquareloss_torch.parallel import ddp

# Cityscapes raw ids that map to trainIds (the blocky synthetic labels use these)
_MAPPED_IDS = (7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 31, 32, 33)

SRC_DISK_WH = (1914, 1052)  # GTA5 native render size
TGT_DISK_WH = (2048, 1024)  # Cityscapes native size
N_PER_DOMAIN = 96


def _synth_pair(rng: np.random.Generator, w: int, h: int):
    """Blocky label field + per-class-coloured image with mild noise, drawn
    at 1/8 scale and upsampled so PNG encoding stays fast and file sizes
    land in a natural-image range."""
    from PIL import Image

    hs, ws = h // 8, w // 8
    lab = np.full((hs, ws), _MAPPED_IDS[0], np.uint8)
    for _ in range(8):
        c = rng.choice(_MAPPED_IDS)
        y0, x0 = rng.integers(0, hs // 2), rng.integers(0, ws // 2)
        lab[y0 : y0 + rng.integers(hs // 8, hs // 2),
            x0 : x0 + rng.integers(ws // 8, ws // 2)] = c
    img_s = np.zeros((hs, ws, 3), np.uint8)
    for c in np.unique(lab):
        cr = np.random.default_rng(int(c))
        img_s[lab == c] = cr.integers(16, 240, size=3).astype(np.uint8)
    img_s = np.clip(
        img_s.astype(np.int16) + rng.integers(-12, 12, size=img_s.shape), 0, 255
    ).astype(np.uint8)
    img = Image.fromarray(img_s).resize((w, h), Image.BILINEAR)
    noise = rng.integers(-6, 6, size=(h, w, 3))
    img = np.clip(np.asarray(img).astype(np.int16) + noise, 0, 255).astype(np.uint8)
    lab = np.asarray(Image.fromarray(lab).resize((w, h), Image.NEAREST))
    return img, lab


def ensure_dataset(
    root: str,
    n: int = N_PER_DOMAIN,
    src_wh: tuple[int, int] = SRC_DISK_WH,
    tgt_wh: tuple[int, int] = TGT_DISK_WH,
) -> str:
    """Write the protocol-shape dataset once; a root whose stamp matches is
    reused as it is."""
    from PIL import Image

    stamp = os.path.join(root, ".complete")
    want = f"v1 n={n} src={src_wh} tgt={tgt_wh}"
    if os.path.exists(stamp) and open(stamp).read() == want:
        return root
    rng = np.random.default_rng(7)
    g = os.path.join(root, "GTA5")
    os.makedirs(f"{g}/images", exist_ok=True)
    os.makedirs(f"{g}/labels", exist_ok=True)
    items = []
    for i in range(n):
        img, lab = _synth_pair(rng, *src_wh)
        Image.fromarray(img).save(f"{g}/images/{i:05d}.png")
        Image.fromarray(lab).save(f"{g}/labels/{i:05d}.png")
        items.append(f"{i:05d}.png")
    with open(f"{g}/train.txt", "w") as f:
        f.write("\n".join(items))

    c = os.path.join(root, "Cityscapes")
    tr = []
    for i in range(n):
        rel = f"leftImg8bit/train/cityA/cityA_{i:06d}_leftImg8bit.png"
        lrel = rel.replace("leftImg8bit", "gtFine", 1).replace(
            "_leftImg8bit.png", "_gtFine_labelIds.png"
        )
        os.makedirs(os.path.dirname(f"{c}/{rel}"), exist_ok=True)
        os.makedirs(os.path.dirname(f"{c}/{lrel}"), exist_ok=True)
        img, lab = _synth_pair(rng, *tgt_wh)
        Image.fromarray(img).save(f"{c}/{rel}")
        Image.fromarray(lab).save(f"{c}/{lrel}")
        tr.append(rel)
    with open(f"{c}/train.txt", "w") as f:
        f.write("\n".join(tr))
    with open(stamp, "w") as f:
        f.write(want)
    return root


def _measure_h2d(batch, device: torch.device, repeats: int = 4) -> float | None:
    """Host → card rate (MB/s) of one batch triple: pinned host tensors,
    ``non_blocking`` copies, one ``torch.cuda.synchronize()`` fence. ``None``
    when the device is not a card."""
    if device.type != "cuda":
        return None
    pinned = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory() for a in batch]
    nbytes = sum(t.numel() * t.element_size() for t in pinned)
    for t in pinned:  # warm the copy path
        t.to(device, non_blocking=True)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(repeats):
        for t in pinned:
            t.to(device, non_blocking=True)
    torch.cuda.synchronize(device)
    return repeats * nbytes / (time.perf_counter() - t0) / 1e6


def _make_loaders(root: str, cfg, cache_root: str | None, num_workers: int):
    from maxsquareloss_torch.data.cityscapes import CityscapesDataset
    from maxsquareloss_torch.data.gta5 import GTA5Dataset
    from maxsquareloss_torch.data.loader import SegDataLoader
    from maxsquareloss_torch.tools.common import transform_cfg

    src = GTA5Dataset(
        root=f"{root}/GTA5", list_path=f"{root}/GTA5/train.txt", split="train",
        transform_cfg=transform_cfg(cfg),
        cache_dir=None if cache_root is None else f"{cache_root}/gta5",
    )
    tgt = CityscapesDataset(
        root=f"{root}/Cityscapes", list_path=f"{root}/Cityscapes/train.txt",
        split="train", transform_cfg=transform_cfg(cfg, target=True),
        cache_dir=None if cache_root is None else f"{cache_root}/cs",
    )
    return tuple(SegDataLoader(ds, batch_size=ddp.local_batch(cfg.batch_size, "--batch"),
                               num_workers=num_workers, seed=cfg.seed,
                               shard_index=ddp.rank(), shard_count=ddp.world())
                 for ds in (src, tgt))


def _timed_epoch(step, state, src_loader, tgt_loader, epoch: int, device: torch.device):
    """One zipped epoch through ``device_prefetch``; returns (images/s,
    images, last loss, last batch triple)."""
    from maxsquareloss_torch.data.loader import device_prefetch

    src_loader.set_epoch(epoch)
    tgt_loader.set_epoch(epoch)
    src = device_prefetch(iter(src_loader), device)
    tgt = device_prefetch(iter(tgt_loader), device)
    n_imgs, metrics, last = 0, None, None
    t0 = time.perf_counter()
    try:
        for (xs, ys, _), (xt, _, _) in zip(src, tgt):
            _, metrics = step(state, xs, ys, xt)
            n_imgs += xs.shape[0] + xt.shape[0]
            last = (xs, ys, xt)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        loss = float(metrics["loss"])  # host read: the epoch is done
    finally:
        src.close()
        tgt.close()
    return n_imgs / (time.perf_counter() - t0), n_imgs, loss, last


def run_e2e(args) -> dict:
    """The e2e result dict from bench-style ``args`` (``batch``, ``dtype``,
    ``epochs``, ``num_workers``, ``data_root``, ``device``, ...). Attributes
    ``blocks``, ``n_per_domain``, ``src_disk_wh``, ``tgt_disk_wh`` and the
    four base/crop sizes shrink the run (the CPU test)."""
    from maxsquareloss_torch.bench import device_report
    from maxsquareloss_torch.config import TrainConfig
    from maxsquareloss_torch.models.deeplabv2 import init_deeplabv2
    from maxsquareloss_torch.tools.prepare_dataset import prepare_split
    from maxsquareloss_torch.train.steps import make_train_state, make_uda_train_step, model_config
    from maxsquareloss_torch.utils.device import resolve_device

    device = resolve_device(getattr(args, "device", None))
    n = getattr(args, "n_per_domain", N_PER_DOMAIN)
    src_wh = tuple(getattr(args, "src_disk_wh", SRC_DISK_WH))
    tgt_wh = tuple(getattr(args, "tgt_disk_wh", TGT_DISK_WH))
    sizes = {k: tuple(getattr(args, k)) for k in
             ("base_size", "crop_size", "target_base_size", "target_crop_size")
             if getattr(args, k, None) is not None}
    blocks = getattr(args, "blocks", (3, 4, 23, 3))
    if isinstance(blocks, str):
        blocks = tuple(int(v) for v in blocks.split(","))
    if ddp.is_main():
        ensure_dataset(args.data_root, n=n, src_wh=src_wh, tgt_wh=tgt_wh)
    ddp.barrier()
    root = args.data_root
    cfg = TrainConfig(
        multi=True, num_classes=19, target_mode="IW_maxsquare",
        # see maxsquareloss_torch/bench.py --iw_hist: random weights
        iw_hist=getattr(args, "iw_hist", "argmax"),
        concat_batches=getattr(args, "concat", False),
        blocks=tuple(blocks), batch_size=args.batch, gaussian_blur=True,
        compute_dtype=args.dtype, remat=getattr(args, "remat", ""),
        # torchvision normalization: from a random init the caffe transform
        # (inputs +-128, no std division) diverges to NaN within an epoch
        numpy_transform=False,
        device_normalize=getattr(args, "device_normalize", True),
        seed=0, device=str(device), **sizes,
    )
    model = init_deeplabv2(model_config(cfg), torch.Generator().manual_seed(0), device=device)
    state = make_train_state(model, cfg)
    step = make_uda_train_step(cfg)
    epochs = max(1, int(getattr(args, "epochs", 3)))
    last = None  # the final batch triple: feeds the h2d and device-only legs

    def timed_leg(data_root, cache_root, first_epoch):
        """A priming epoch, then ``epochs`` timed ones: (rates, images an
        epoch, last loss)."""
        nonlocal last
        s_l, t_l = _make_loaders(data_root, cfg, cache_root, args.num_workers)
        _timed_epoch(step, state, s_l, t_l, first_epoch, device)
        rates, n_imgs, leg_loss = [], 0, float("nan")
        for e in range(first_epoch + 1, first_epoch + 1 + epochs):
            r, n_imgs, leg_loss, last = _timed_epoch(step, state, s_l, t_l, e, device)
            rates.append(r)
        return rates, n_imgs, leg_loss

    # final_loss is the cold leg's; later legs keep training the same state
    cold_rates, n_imgs, loss = timed_leg(root, None, 0)
    warm_rates, _, _ = timed_leg(root, os.path.join(root, "_cache"), 100)
    prepared = {}
    for leg, fmt, first_epoch in (("prepared", "png", 200), ("prepared_raw", "raw", 300)):
        prep_root = root.rstrip("/") + "_" + leg
        if ddp.is_main():
            prepare_split("gta5", f"{root}/GTA5", f"{root}/GTA5/train.txt", f"{prep_root}/GTA5",
                          tuple(cfg.base_size), "train", num_workers=args.num_workers, fmt=fmt)
            prepare_split("cityscapes", f"{root}/Cityscapes", f"{root}/Cityscapes/train.txt",
                          f"{prep_root}/Cityscapes", tuple(cfg.target_base_size), "train",
                          num_workers=args.num_workers, fmt=fmt)
        ddp.barrier()
        prepared[leg] = timed_leg(prep_root, None, first_epoch)[0]

    xs, ys, xt = last
    host = [a.cpu().numpy() for a in last]
    h2d_mbps = _measure_h2d(host, device)

    # device-only ceiling: the same step on the device-resident last batch
    for _ in range(2):
        step(state, xs, ys, xt)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    k = 6
    t0 = time.perf_counter()
    for _ in range(k):
        _, metrics = step(state, xs, ys, xt)
    float(metrics["loss"])  # host read: the steps are done
    dev_rate = k * (xs.shape[0] + xt.shape[0]) / (time.perf_counter() - t0)

    rates = {"cold": cold_rates, "warm": warm_rates, **prepared}
    medians = {leg: float(np.median(r)) for leg, r in rates.items()}
    return {
        "metric": (f"e2e_uda_images_per_sec_per_chip_src{cfg.base_size[0]}x{cfg.base_size[1]}"
                   f"_tgt{cfg.target_base_size[0]}x{cfg.target_base_size[1]}_{args.dtype}"),
        "value": medians["warm"],
        "unit": "images/sec/chip",
        "extra": {
            **{f"e2e_{leg}_imgs_per_sec": v for leg, v in medians.items()},
            "timed_epochs_each": epochs,
            **{f"e2e_{leg}_epoch_rates": r for leg, r in rates.items()},
            "device_only_imgs_per_sec": dev_rate,
            "host_device_ratio_warm": medians["warm"] / dev_rate,
            "h2d_MB_per_sec": h2d_mbps,
            "h2d_MB_per_step": sum(a.nbytes for a in host) / 1e6,
            "device_normalize": bool(cfg.device_normalize),
            "epoch_images": n_imgs,
            "num_workers": args.num_workers,
            "global_batch": args.batch,
            "blocks": ",".join(str(b) for b in cfg.blocks),
            "iw_hist": cfg.iw_hist,
            "concat_batches": cfg.concat_batches,
            "compute_dtype": cfg.compute_dtype,
            "remat": cfg.remat,
            "final_loss": loss,
            "chips": ddp.world(),
            **device_report(device),
        },
    }
