"""The host data path on its own: the host extension (``data/hostops.py``)
held to PIL byte for byte, the routes of a sample held to each other, and
per-sample host times at the protocol's shapes.

    python -m maxsquareloss_torch.experiments.host_data [--work DIR]

Prints one JSON object a line and exits non-zero on any mismatch:
  build       the extension's build: seconds, and whether it was built or found
  decode      every PNG kind of ``PNG_KINDS`` x ``expand_rgb``, written by
              ``encode_png`` (each row filter in turn, IDAT in three chunks):
              the extension's decode against PIL's reading (``pil_expected``)
              and against the samples written
  blur        random (radius, size, channels) draws: the extension's blur
              against Pillow's ``GaussianBlur``
  routes      a small GTA5 (palette labels), Cityscapes (gray labels), SYNTHIA
              (16-bit RGB labels) and raw-prepared root, train and val, both
              ``device_normalize`` settings: every sample of the fused routes
              against the general path with the extension off (PIL)
  per_sample  one thread, GTA5 pairs at 1914x1052 trained at base 1280x720
              (mirror and blur on, uint8 out): ms a sample from the
              native-size PNGs (decode + resize), the prepared PNGs (the fused
              route) and the prepared raw sidecars, each with the extension
              and with PIL; the blur alone at 1280x720; the probes a
              sample pays on a root that takes the general path (the raw
              sidecars' miss and the IHDR peeks)
The CPU tests take ``encode_png``, ``PNG_KINDS`` and ``pil_expected`` from here.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import struct
import sys
import tempfile
import time
import warnings
import zlib
from unittest import mock

import numpy as np

from maxsquareloss_torch.data import hostops

# name: (PNG colour type, bit depth, samples a pixel, with a tRNS chunk)
PNG_KINDS = {
    "rgb8": (2, 8, 3, False), "rgb8_trns": (2, 8, 3, True), "rgba8": (6, 8, 4, False),
    "gray1": (0, 1, 1, False), "gray2": (0, 2, 1, False), "gray4": (0, 4, 1, False),
    "gray8": (0, 8, 1, False), "gray8_trns": (0, 8, 1, True), "gray16": (0, 16, 1, False),
    "rgb16": (2, 16, 3, False), "rgba16": (6, 16, 4, False), "la8": (4, 8, 2, False),
    "la16": (4, 16, 2, False), "palette1": (3, 1, 1, False), "palette4": (3, 4, 1, False),
    "palette4_trns": (3, 4, 1, True), "palette8": (3, 8, 1, False),
    "palette8_trns": (3, 8, 1, True),
}


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def _filter_row(f: int, r: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """Filter type ``f`` of one row of bytes (int32, so the sums do not wrap)."""
    left = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
    if f == 1:
        return r - left
    if f == 2:
        return r - prev
    if f == 3:
        return r - (left + prev) // 2
    if f == 4:
        p = left + prev - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
        return r - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
    return r


# Adam7's passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _row_bytes(s: np.ndarray, depth: int) -> np.ndarray:
    """One row's samples as its bytes (int32), big-endian, sub-8-bit packed."""
    if depth == 16:
        raw = s.astype(">u2").tobytes()
    elif depth == 8:
        raw = s.astype(np.uint8).tobytes()
    else:  # 8 // depth samples a byte, the first in the high bits
        per = 8 // depth
        v = np.concatenate([s, np.zeros((-len(s)) % per, s.dtype)]).astype(np.uint8)
        shifts = np.array([8 - depth * (i + 1) for i in range(per)], np.uint8)
        raw = np.bitwise_or.reduce(v.reshape(-1, per) << shifts, axis=1).astype(np.uint8).tobytes()
    return np.frombuffer(raw, np.uint8).astype(np.int32)


def _filtered(image: np.ndarray, depth: int, filters, start: int = 0) -> list[bytes]:
    """The rows of ``image`` (H, W, C), row y filtered with
    ``filters[(start + y) % len(filters)]``, each led by its filter byte."""
    bpp = max(1, image.shape[2] * depth // 8)
    out, prev = [], None
    for y in range(image.shape[0]):
        r = _row_bytes(image[y].reshape(-1), depth)
        prev = np.zeros_like(r) if prev is None else prev
        f = filters[(start + y) % len(filters)]
        out.append(bytes([f]) + (_filter_row(f, r, prev, bpp) & 255).astype(np.uint8).tobytes())
        prev = r
    return out


def encode_png(samples: np.ndarray, color: int, depth: int, palette=None, trns=None,
               filters=(0,), idat_pieces: int = 1, interlace: bool = False) -> bytes:
    """A PNG of ``samples`` (H, W, C) in the given colour type and bit depth,
    row y filtered with ``filters[y % len(filters)]``, the compressed data
    split over ``idat_pieces`` IDAT chunks; ``interlace`` writes Adam7."""
    h, w, _ = samples.shape
    if interlace:
        rows = []
        for x0, y0, dx, dy in _ADAM7:
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                rows += _filtered(sub, depth, filters, len(rows))
    else:
        rows = _filtered(samples, depth, filters)
    z = np.frombuffer(zlib.compress(b"".join(rows)), np.uint8)
    png = b"\x89PNG\r\n\x1a\n" + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace)))
    if palette is not None:
        png += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        png += _chunk(b"tRNS", trns)
    for piece in np.array_split(z, idat_pieces):
        png += _chunk(b"IDAT", piece.tobytes())
    return png + _chunk(b"IEND", b"")


def make_png(kind: str, rng: np.random.Generator, hw=(7, 13)) -> tuple[bytes, np.ndarray]:
    """(PNG bytes, the samples written (H, W, C)) of one ``PNG_KINDS`` entry,
    random samples and palette, every row filter in turn, IDAT in 3 chunks."""
    color, depth, c, with_trns = PNG_KINDS[kind]
    samples = rng.integers(0, 2 ** depth, (*hw, c))
    palette = rng.integers(0, 256, (2 ** depth, 3)) if color == 3 else None
    trns = None
    if with_trns:  # one alpha a palette entry; else the transparent colour's samples
        n = 2 ** depth if color == 3 else c
        top = 256 if color == 3 else 2 ** depth
        trns = rng.integers(0, top, n).astype(">u1" if color == 3 else ">u2").tobytes()
    png = encode_png(samples, color, depth, palette, trns, filters=(0, 1, 2, 3, 4),
                     idat_pieces=3)
    return png, samples


def pil_expected(png: bytes, expand_rgb: bool) -> np.ndarray:
    """The extension's decode, in terms of PIL's reading of the file.

    ``expand_rgb``: ``Image.open(p).convert("RGB")``, except 16-bit gray,
    which PIL clips to 255 and the extension takes the high byte of (as
    libpng's ``png_set_strip_16``): PIL's 16-bit samples >> 8, replicated.
    Stored samples: ``np.asarray(Image.open(p))`` (palette indices), with
    1-bit gray as 0/1 (PIL: bool), 2- and 4-bit gray unscaled (PIL: times 85
    and 17), and 16-bit colour as PIL's 8-bit samples in the high byte (PIL
    keeps only that; the low byte is held to the samples written)."""
    from PIL import Image

    im = Image.open(io.BytesIO(png))
    color, depth = png[25], png[24]
    if expand_rgb:
        if color == 0 and depth == 16:
            return np.repeat((np.asarray(im) >> 8).astype(np.uint8)[..., None], 3, axis=2)
        with warnings.catch_warnings():  # a palette's tRNS: PIL suggests RGBA
            warnings.simplefilter("ignore", UserWarning)
            return np.asarray(im.convert("RGB"))
    arr = np.asarray(im)
    if color == 0 and depth < 8:
        return arr.astype(np.uint8) if depth == 1 else arr // (255 // (2 ** depth - 1))
    if depth == 16 and color != 0:
        return arr[..., [0, 3]] if color == 4 else arr  # PIL reads LA16 as RGBA
    return arr


def decode_case(kind: str, expand_rgb: bool, rng: np.random.Generator) -> dict:
    """One decode case: equal to ``pil_expected`` and to the samples written."""
    color, depth, _, _ = PNG_KINDS[kind]
    png, samples = make_png(kind, rng)
    got = hostops.decode_png(png, expand_rgb)
    want = pil_expected(png, expand_rgb)
    if not expand_rgb:
        source = samples[..., 0] if samples.shape[-1] == 1 else samples
        pil_got = got >> 8 if depth == 16 and color != 0 else got
        return {"kind": kind, "expand_rgb": expand_rgb, "dtype": str(got.dtype),
                "pil_equal": bool(np.array_equal(pil_got, want)),
                "samples_equal": bool(np.array_equal(got, source))}
    return {"kind": kind, "expand_rgb": expand_rgb, "dtype": str(got.dtype),
            "pil_equal": bool(got.dtype == np.uint8 and np.array_equal(got, want)),
            "samples_equal": True}


def decode_matrix(rng: np.random.Generator) -> list[dict]:
    return [decode_case(k, e, rng) for k in PNG_KINDS for e in (True, False)]


def blur_draws(rng: np.random.Generator, n: int) -> list[dict]:
    """The draws (radius, h, w, c) on which the extension's blur is not
    Pillow's, byte for byte: radius uniform in [0, 1) (the training range)
    and [0, 3) in turn, sizes 1-40, gray or RGB."""
    from PIL import Image, ImageFilter

    bad = []
    for i in range(n):
        radius = float(rng.uniform(0.0, 1.0 if i % 2 else 3.0))
        h, w, c = int(rng.integers(1, 41)), int(rng.integers(1, 41)), int(rng.choice([1, 3]))
        img = rng.integers(0, 256, (h, w, 3) if c == 3 else (h, w)).astype(np.uint8)
        want = np.asarray(Image.fromarray(img).filter(ImageFilter.GaussianBlur(radius=radius)))
        if not np.array_equal(hostops.gaussian_blur(img, radius), want):
            bad.append({"radius": radius, "h": h, "w": w, "c": c})
    return bad


@contextlib.contextmanager
def extension_off():
    """The datasets as without the extension: PIL decode and blur, no fused PNG route."""
    with mock.patch.object(hostops, "available", return_value=False):
        yield


@contextlib.contextmanager
def general_path_only():
    """The extension off and the fused routes (the raw one too) declined."""
    from maxsquareloss_torch.data.cityscapes import SegDataset

    with extension_off(), \
            mock.patch.object(SegDataset, "_fused_train_sample", lambda *a: None), \
            mock.patch.object(SegDataset, "_fused_val_sample", lambda *a: None):
        yield


# Cityscapes raw label ids of the routes' fixture: the 19 mapped ones and a few unmapped
_ROUTE_IDS = np.array([7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 31, 32,
                       33, 0, 1, 4, 255], np.uint8)


# with 4 samples a root, the draws of seed 2 over 2 epochs meet every
# (mirror, blur) pair
ROUTE_SEED = 2


def write_route_roots(base: str, rng: np.random.Generator, hw=(24, 40), n: int = 4) -> dict:
    """Tiny roots at ``hw`` for the route checks: GTA5 with palette label
    PNGs (as GTA5 ships them), Cityscapes train/val with gray label PNGs,
    SYNTHIA with 16-bit RGB label PNGs (the class id in R), and a
    raw-prepared copy of the GTA5 root. {name: (dataset, root, list, split)}."""
    from PIL import Image

    h, w = hw
    palette = rng.integers(0, 256, (256, 3)).astype(np.uint8)

    def image():
        return rng.integers(0, 256, (h, w, 3)).astype(np.uint8)

    names = [f"{i:05d}.png" for i in range(n)]
    g5, raw = os.path.join(base, "GTA5"), os.path.join(base, "GTA5_raw")
    for d in (f"{g5}/images", f"{g5}/labels", f"{raw}/images", f"{raw}/labels"):
        os.makedirs(d, exist_ok=True)
    for name in names:
        img, ids = image(), rng.choice(_ROUTE_IDS, (h, w)).astype(np.uint8)
        Image.fromarray(img).save(f"{g5}/images/{name}")
        lab = Image.fromarray(ids, "P")
        lab.putpalette(palette.tobytes())
        lab.save(f"{g5}/labels/{name}")
        np.save(f"{raw}/images/{name}.npy", img)
        np.save(f"{raw}/labels/{name}.npy", ids)
    for root in (g5, raw):
        with open(f"{root}/train.txt", "w") as f:
            f.write("\n".join(names))
    cs = os.path.join(base, "Cityscapes")
    for split in ("train", "val"):
        rels = []
        for i in range(n):
            rel = f"leftImg8bit/{split}/a/a_{i:06d}_leftImg8bit.png"
            lrel = rel.replace("leftImg8bit", "gtFine", 1).replace(
                "_leftImg8bit.png", "_gtFine_labelIds.png")
            for p in (rel, lrel):
                os.makedirs(os.path.dirname(f"{cs}/{p}"), exist_ok=True)
            Image.fromarray(image()).save(f"{cs}/{rel}")
            Image.fromarray(rng.choice(_ROUTE_IDS, (h, w)).astype(np.uint8)).save(f"{cs}/{lrel}")
            rels.append(rel)
        with open(f"{cs}/{split}.txt", "w") as f:
            f.write("\n".join(rels))
    sy = os.path.join(base, "SYNTHIA")
    os.makedirs(f"{sy}/RGB", exist_ok=True)
    os.makedirs(f"{sy}/GT/LABELS", exist_ok=True)
    for name in names:
        Image.fromarray(image()).save(f"{sy}/RGB/{name}")
        rgb = rng.integers(0, 65536, (h, w, 3))
        rgb[..., 0] = rng.integers(0, 23, (h, w))  # R: the SYNTHIA class id
        with open(f"{sy}/GT/LABELS/{name}", "wb") as f:
            f.write(encode_png(rgb, 2, 16, filters=(1, 4)))
    with open(f"{sy}/train.txt", "w") as f:
        f.write("\n".join(names))
    return {"gta5": ("gta5", g5, f"{g5}/train.txt", "train"),
            "gta5_raw": ("gta5", raw, f"{raw}/train.txt", "train"),
            "cityscapes_train": ("cityscapes", cs, f"{cs}/train.txt", "train"),
            "cityscapes_val": ("cityscapes", cs, f"{cs}/val.txt", "val"),
            "synthia": ("synthia", sy, f"{sy}/train.txt", "train")}


def route_case(spec: tuple, hw, device_normalize: bool, seed: int = ROUTE_SEED, **tkw) -> dict:
    """Every sample of one root through the fused routes and through the
    general path with the extension off, two epochs: equal bit for bit,
    and the fused route taken for every sample."""
    from maxsquareloss_torch.data.cityscapes import SegDataset
    from maxsquareloss_torch.data.transforms import TransformConfig
    from maxsquareloss_torch.tools.common import DATASET_CLS

    name, root, list_path, split = spec
    base = (hw[1], hw[0])
    cfg = TransformConfig(base_size=base, crop_size=base, device_normalize=device_normalize,
                          **tkw)
    ds = DATASET_CLS[name](root, list_path, split=split, transform_cfg=cfg,
                           class_16=name == "synthia")
    fused_calls = []
    fused = SegDataset._fused_train_sample if split == "train" else SegDataset._fused_val_sample

    def counted(self, *a):
        out = fused(self, *a)
        fused_calls.append(out is not None)
        return out

    pairs = [(e, i) for e in range(2) for i in range(len(ds))]
    attr = fused.__name__
    with mock.patch.object(SegDataset, attr, counted):
        got = [ds.get(i, np.random.default_rng((seed, e, i))) for e, i in pairs]
    with general_path_only():
        want = [ds.get(i, np.random.default_rng((seed, e, i))) for e, i in pairs]
    equal = all(a[0].dtype == b[0].dtype and a[1].dtype == b[1].dtype
                and np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                for a, b in zip(got, want))
    return {"samples": len(pairs), "fused": int(sum(fused_calls)), "equal": bool(equal)}


def route_checks(base: str, rng: np.random.Generator) -> list[dict]:
    hw = (24, 40)
    roots = write_route_roots(base, rng, hw)
    out = []
    for key, spec in roots.items():
        for dn in (False, True):
            for numpy_transform in (True, False):
                r = route_case(spec, hw, dn, numpy_transform=numpy_transform)
                out.append({"root": key, "device_normalize": dn,
                            "numpy_transform": numpy_transform, **r})
    return out


def _mean_ms(fn, n: int, passes: int = 2) -> float:
    fn(0, 0)  # warm: page cache, the extension loaded
    t0 = time.perf_counter()
    for e in range(passes):
        for i in range(n):
            fn(i, e + 1)
    return 1e3 * (time.perf_counter() - t0) / (passes * n)


def per_sample_ms(work: str, n: int = 8) -> dict:
    """ms a sample, one thread (see the module docstring)."""
    from maxsquareloss_torch.data.gta5 import GTA5Dataset
    from maxsquareloss_torch.data.transforms import TransformConfig, gaussian_blur
    from maxsquareloss_torch.experiments.bench_e2e import SRC_DISK_WH, _synth_pair
    from maxsquareloss_torch.tools.prepare_dataset import prepare_split
    from PIL import Image, ImageFilter

    base = (1280, 720)
    src = os.path.join(work, "GTA5")
    os.makedirs(f"{src}/images", exist_ok=True)
    os.makedirs(f"{src}/labels", exist_ok=True)
    rng = np.random.default_rng(7)
    names = [f"{i:05d}.png" for i in range(n)]
    for name in names:
        img, lab = _synth_pair(rng, *SRC_DISK_WH)
        Image.fromarray(img).save(f"{src}/images/{name}")
        Image.fromarray(lab).save(f"{src}/labels/{name}")
    with open(f"{src}/train.txt", "w") as f:
        f.write("\n".join(names))
    roots = {"native_size_png": src}
    for leg, fmt in (("prepared_png", "png"), ("prepared_raw", "raw")):
        roots[leg] = os.path.join(work, leg)
        prepare_split("gta5", src, f"{src}/train.txt", roots[leg], base, "train",
                      num_workers=1, fmt=fmt)
    cfg = TransformConfig(base_size=base, crop_size=base, device_normalize=True,
                          numpy_transform=False)
    out = {"samples": n, "base_size": list(base), "disk_wh": list(SRC_DISK_WH)}
    for leg, root in roots.items():
        ds = GTA5Dataset(root, f"{root}/train.txt", split="train", transform_cfg=cfg)

        def sample(i, e, ds=ds):
            return ds.get(i, np.random.default_rng((0, e, i)))

        out[f"{leg}_native_ms"] = _mean_ms(sample, n)
        with extension_off():
            out[f"{leg}_pil_ms"] = _mean_ms(sample, n)
    x = np.asarray(Image.open(f"{roots['prepared_png']}/images/{names[0]}").convert("RGB"))
    out["blur_native_ms"] = _mean_ms(lambda i, e: gaussian_blur(x, 0.5), n)
    out["blur_pil_ms"] = _mean_ms(lambda i, e: Image.fromarray(x).filter(
        ImageFilter.GaussianBlur(radius=0.5)), n)
    ds = GTA5Dataset(src, f"{src}/train.txt", split="train", transform_cfg=cfg)
    paths = [ds._pair_paths(item) for item in ds.items]
    out["route_probe_ms"] = _mean_ms(
        lambda i, e: (ds._load_raw_pair(*paths[i]), ds._base_size_pngs(*paths[i])), n)
    with open(f"{roots['prepared_png']}/images/{names[0]}", "rb") as f:
        png = f.read()
    out["decode_native_ms"] = _mean_ms(lambda i, e: hostops.decode_png(png, True), n)
    out["decode_pil_ms"] = _mean_ms(
        lambda i, e: np.asarray(Image.open(io.BytesIO(png)).convert("RGB")), n)
    return out


def build_report() -> dict:
    lib_before = {p.name for p in hostops.BUILD_DIR.glob(f"{hostops.MODULE}-*")} \
        if hostops.BUILD_DIR.exists() else set()
    t0 = time.perf_counter()
    lib = hostops.build()
    seconds = time.perf_counter() - t0
    hostops._ext()
    return {"library": lib.name, "built": lib.name not in lib_before, "seconds": seconds}


def run(work: str, emit) -> bool:
    """Every part in turn, each reported through ``emit``; True when all agree."""
    from PIL import __version__ as pil_version

    emit({"part": "build", "pillow": pil_version, **build_report()})
    rng = np.random.default_rng(0)
    cases = decode_matrix(rng)
    bad_decode = [c for c in cases if not (c["pil_equal"] and c["samples_equal"])]
    emit({"part": "decode", "cases": len(cases), "mismatches": bad_decode})
    bad_blur = blur_draws(rng, 200)
    emit({"part": "blur", "draws": 200, "mismatches": bad_blur})
    routes = route_checks(os.path.join(work, "routes"), rng)
    bad_routes = [r for r in routes if not r["equal"] or r["fused"] != r["samples"]]
    emit({"part": "routes", "cases": len(routes),
          "samples": sum(r["samples"] for r in routes), "mismatches": bad_routes})
    emit({"part": "per_sample", **per_sample_ms(os.path.join(work, "timing"))})
    return not (bad_decode or bad_blur or bad_routes)


def main(argv=None) -> int:
    p = argparse.ArgumentParser("host_data")
    p.add_argument("--work", default=None, help="scratch directory (a temporary one by default)")
    args = p.parse_args(argv)
    if not hostops.available():
        print("host_data: no g++ or no zlib.h here; the extension cannot be built",
              file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory(prefix="host_data_") as tmp:
        ok = run(args.work or tmp, lambda obj: print(json.dumps(obj), flush=True))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
