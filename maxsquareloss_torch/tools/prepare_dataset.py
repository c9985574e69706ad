"""Pre-resize a dataset to base_size on disk, once (counterpart of
``tools/prepare_dataset.py``).

A training epoch decodes every PNG and resizes it from its native size to
base_size (PIL BICUBIC for images, NEAREST for labels). That work is the
same every epoch, so this tool does it once through the dataset class's own
loaders and writes the result in the same relative layout, with the split
list beside it. Point ``--data_root_path`` at the output root afterwards:
the stream is bitwise the one from the original root when ``random_mirror``
is off (with it on, a mirrored sample's flip now happens at base_size, and
PIL's resample grid is not exactly flip-equivariant, so isolated pixels
may differ).

``--format png`` writes lossless PNGs; ``--format raw`` writes ``.npy``
sidecars of the decoded pixels (``<path>.npy``), which the datasets read
without any PNG decode::

    python -m maxsquareloss_torch.tools.prepare_dataset --dataset gta5 \\
        --data_root_path ./datasets --output_root ./datasets_720p \\
        --base_size 1280,720 --splits train

A re-run reuses every output that has the right size and is newer than its
input, and redoes the rest. Host-side only: it runs no device work.
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from maxsquareloss_torch.data.cityscapes import _peek_png, _raw_path
from maxsquareloss_torch.data.transforms import TransformConfig


def _raw_meta(path: str):
    """(shape, dtype) from an .npy header without reading the data;
    (None, None) if absent."""
    try:
        a = np.load(path, mmap_mode="r")
        return a.shape, a.dtype
    except (OSError, ValueError):
        return None, None


def _label_ids(mask, path: str) -> np.ndarray:
    """Raw label ids as uint8, or uint16 when wider (SYNTHIA)."""
    arr = np.asarray(mask)
    if arr.dtype == np.uint8:
        return arr
    ids = arr.astype(np.int64)
    if ids.min() < 0 or ids.max() > 0xFFFF:
        raise ValueError(f"label ids outside uint16 range in {path}")
    return ids.astype(np.uint16)


def _save_raw(arr: np.ndarray, path: str) -> None:
    """Atomic .npy write."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.save(f, arr)
    os.replace(tmp, path)


def prepare_split(
    dataset: str,
    root: str,
    list_path: str,
    out_root: str,
    base_size: tuple[int, int],
    split: str,
    num_workers: int = 4,
    force: bool = False,
    city_name: str | None = None,
    fmt: str = "png",
) -> int:
    """Pre-resize every (image, label) pair of one split; returns the pair
    count. Outputs mirror the input layout under ``out_root``; a pair whose
    label file is missing (an unlabeled split) writes the image only."""
    from PIL import Image

    from maxsquareloss_torch.tools.common import DATASET_CLS

    kw = {"city_name": city_name} if dataset == "crosscity" and city_name else {}
    ds = DATASET_CLS[dataset](
        root, list_path, split=split,
        transform_cfg=TransformConfig(base_size=base_size, crop_size=base_size), **kw,
    )

    def fresh(out_path: str, in_path: str, is_label: bool = False) -> bool:
        """Reusable output: the right size (header peek) and newer than its
        input, so a re-run after a base_size change or a regenerated source
        never serves stale pixels."""
        if fmt == "raw":
            want = (base_size[1], base_size[0]) + (() if is_label else (3,))
            ok = _raw_meta(out_path)[0] == want
        else:
            hdr = _peek_png(out_path)
            ok = hdr is not None and hdr.size == tuple(base_size)
        return ok and os.path.getmtime(out_path) >= os.path.getmtime(in_path)

    def one(item: str) -> None:
        img_path, lab_path = ds._pair_paths(item)
        out_img = os.path.join(out_root, os.path.relpath(img_path, root))
        out_lab = os.path.join(out_root, os.path.relpath(lab_path, root))
        if fmt == "raw":
            out_img, out_lab = _raw_path(out_img), _raw_path(out_lab)
        else:
            # the datasets prefer a .npy sidecar: a png re-prepare over a
            # raw-prepared root removes them, or the old pixels would win
            for stale in (_raw_path(out_img), _raw_path(out_lab)):
                if os.path.exists(stale):
                    os.remove(stale)
        has_label = os.path.exists(lab_path)
        if not force and fresh(out_img, img_path) and (
            not has_label or fresh(out_lab, lab_path, is_label=True)
        ):
            return
        os.makedirs(os.path.dirname(out_img), exist_ok=True)
        img = ds._load_image(img_path).resize(base_size, Image.BICUBIC)
        if fmt == "raw":
            _save_raw(np.asarray(img, dtype=np.uint8), out_img)
        else:
            img.save(out_img + ".tmp", format="PNG")
            os.replace(out_img + ".tmp", out_img)
        if has_label:
            os.makedirs(os.path.dirname(out_lab), exist_ok=True)
            ids = _label_ids(ds._load_mask(lab_path).resize(base_size, Image.NEAREST), out_lab)
            if fmt == "raw":
                _save_raw(ids, out_lab)
            else:  # 8-bit gray, or 16-bit gray for wider ids: both lossless
                Image.fromarray(ids).save(out_lab + ".tmp", format="PNG")
                os.replace(out_lab + ".tmp", out_lab)

    with ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
        list(pool.map(one, ds.items))

    # the split list rides along; a list outside the dataset root must not
    # make the relative path escape out_root and overwrite the user's file
    rel_list = os.path.relpath(os.path.abspath(list_path), os.path.abspath(root))
    if rel_list.startswith(os.pardir):
        rel_list = f"{split}.txt"
    out_list = os.path.join(out_root, rel_list)
    os.makedirs(os.path.dirname(out_list), exist_ok=True)
    with open(out_list, "w") as f:
        f.write("\n".join(ds.items) + "\n")
    return len(ds.items)


def main(argv=None) -> None:
    from maxsquareloss_torch.tools.common import default_paths

    p = argparse.ArgumentParser("prepare_dataset")
    p.add_argument("--dataset", required=True,
                   choices=("cityscapes", "gta5", "synthia", "crosscity"))
    p.add_argument("--data_root_path", default="./datasets")
    p.add_argument("--output_root", required=True,
                   help="output datasets root (mirrors the input layout)")
    p.add_argument("--base_size", default="1280,720", help="W,H")
    p.add_argument("--splits", default="train", help="comma-separated")
    p.add_argument("--list_path", default=None, help="explicit split list (single split only)")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--city_name", default=None, help="crosscity only")
    p.add_argument("--force", action="store_true", help="re-write existing outputs")
    p.add_argument("--format", default="png", choices=("png", "raw"), dest="fmt",
                   help="'png' = lossless PNGs; 'raw' = .npy pixel sidecars that the "
                        "datasets read without a PNG decode")
    args = p.parse_args(argv)

    splits = [s.strip() for s in args.splits.split(",") if s.strip()]
    if args.list_path and len(splits) != 1:
        raise SystemExit("--list_path applies to exactly one --splits entry")
    w, h = (int(v) for v in args.base_size.split(","))
    paths = default_paths(args.data_root_path)[args.dataset]
    out_ds_root = os.path.join(args.output_root, os.path.basename(os.path.normpath(paths["root"])))
    for split in splits:
        n = prepare_split(
            args.dataset, paths["root"], args.list_path or paths[split], out_ds_root,
            (w, h), split, num_workers=args.num_workers, force=args.force,
            city_name=args.city_name, fmt=args.fmt,
        )
        print(f"prepared {args.dataset}/{split}: {n} pairs at {w}x{h} ({args.fmt}) → {out_ds_root}")


if __name__ == "__main__":
    main()
