"""The port's host extension (``maxsquareloss_torch/csrc/hostops.cpp``, PNG
decode over zlib) against PIL, numpy and, where it is built, the JAX
package's libpng extension.

Every PNG kind of ``experiments/host_data.PNG_KINDS`` (RGB8, RGBA8, gray
1/2/4/8/16, RGB16, RGBA16, LA8, LA16, palette 1/4/8-bit with and without
tRNS) is written by the test encoder with each row filter in turn over
three IDAT chunks, and decoded in both ``expand_rgb`` modes: bitwise equal
to PIL's reading in the terms ``pil_expected`` states and to the samples
written. Palette labels read as indices, where the JAX extension reads the
palette's red value (a reference defect, recorded and not copied). Corrupt
and interlaced files raise; the blur is byte-exact against Pillow and the
JAX extension. The module skips only where no ``g++`` or no ``zlib.h`` is
found.
"""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image, ImageFilter

from maxsquareloss_torch.data import hostops
from maxsquareloss_torch.data.palette import IMG_MEAN
from maxsquareloss_torch.experiments import host_data
from maxsquareloss_tpu.data import hostops as jax_hostops

pytestmark = pytest.mark.skipif(not hostops.available(), reason="no g++ or no zlib.h here")

# the JAX package's own decode, where its libpng extension is built
jax_native = pytest.mark.skipif(not jax_hostops.available(),
                                reason="the JAX package's extension is not built")


@pytest.mark.parametrize("expand_rgb", [True, False], ids=["rgb", "stored"])
@pytest.mark.parametrize("kind", list(host_data.PNG_KINDS))
def test_decode_matches_pil(kind, expand_rgb):
    rng = np.random.default_rng(sum(map(ord, kind)))
    png, samples = host_data.make_png(kind, rng)
    got = hostops.decode_png(png, expand_rgb)
    want = host_data.pil_expected(png, expand_rgb)
    color, depth, c, _ = host_data.PNG_KINDS[kind]
    if expand_rgb:
        assert got.dtype == np.uint8 and got.shape == (7, 13, 3)
        assert np.array_equal(got, want)
    else:
        assert got.dtype == (np.uint16 if depth == 16 else np.uint8)
        assert np.array_equal(got >> 8 if depth == 16 and color != 0 else got, want)
        assert np.array_equal(got, samples[..., 0] if c == 1 else samples)
    if jax_hostops.available() and not (color == 3 and not expand_rgb):
        # the JAX extension agrees everywhere but on stored palette samples
        assert np.array_equal(got, jax_hostops.decode_png(png, expand_rgb).reshape(got.shape))


def test_pil_departures_are_the_stated_ones():
    """16-bit gray: PIL's convert("RGB") clips, the extension keeps the high
    byte (the datasets read such images through PIL); 2-bit gray: PIL scales
    the stored samples by 85."""
    rng = np.random.default_rng(3)
    png, samples = host_data.make_png("gray16", rng)
    from_pil = np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))[..., 0]
    assert np.array_equal(from_pil, np.minimum(samples[..., 0], 255))
    assert np.array_equal(hostops.decode_png(png, True)[..., 0], samples[..., 0] >> 8)
    png, samples = host_data.make_png("gray2", rng)
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(png))), samples[..., 0] * 85)


def _palette_label(h=8, w=10):
    """A 'P' label PNG whose palette's red is (i*37) % 256, and its indices."""
    idx = (np.arange(h * w).reshape(h, w) * 7 % 256).astype(np.uint8)
    img = Image.fromarray(idx, "P")
    img.putpalette([v for i in range(256) for v in ((i * 37) % 256, i, 255 - i)])
    buf = io.BytesIO()
    img.save(buf, "PNG")
    return buf.getvalue(), idx


def test_palette_labels_read_as_indices():
    png, idx = _palette_label()
    identity = np.arange(256, dtype=np.int32)
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(png))), idx)
    assert np.array_equal(hostops.decode_png(png, False), idx)
    assert np.array_equal(hostops.decode_remap(png, identity), idx)


@jax_native
def test_jax_extension_reads_palette_red_not_the_index():
    """The recorded reference defect (``native/hostops.cpp`` expands the
    palette in its label branch): the JAX extension gives palette_R[idx],
    where PIL and the port give idx."""
    png, idx = _palette_label()
    red = (np.arange(256) * 37 % 256)[idx]
    got = jax_hostops.decode_remap(png, np.arange(256, dtype=np.int32))
    assert np.array_equal(got, red) and not np.array_equal(got, idx)
    assert np.array_equal(hostops.decode_remap(png, np.arange(256, dtype=np.int32)), idx)


def _rechunk(png: bytes, kind: bytes, data: bytes) -> bytes:
    """``png`` with its first ``kind`` chunk's data replaced (CRC redone)."""
    off = 8
    while True:
        n = struct.unpack(">I", png[off:off + 4])[0]
        if png[off + 4:off + 8] == kind:
            return png[:off] + host_data._chunk(kind, data) + png[off + 12 + n:]
        off += 12 + n


def _corrupt(case: str) -> bytes:
    rng = np.random.default_rng(0)
    png, samples = host_data.make_png("rgb8", rng)
    ihdr_crc = 8 + 8 + 13  # the IHDR chunk's CRC
    if case == "signature":
        return b"\x89PNX" + png[4:]
    if case == "ihdr_crc":
        return png[:ihdr_crc] + bytes([png[ihdr_crc] ^ 1]) + png[ihdr_crc + 1:]
    if case == "idat_crc":
        i = png.index(b"IDAT") + 6  # a byte of the first IDAT's data
        return png[:i] + bytes([png[i] ^ 0x40]) + png[i + 1:]
    if case == "chunk_truncated":
        return png[:-30]
    if case == "zlib_short":  # a whole, valid stream of too few rows
        filtered = b"".join(b"\x00" + r.astype(np.uint8).tobytes() for r in samples[:5])
        return _rechunk(host_data.encode_png(samples, 2, 8), b"IDAT", zlib.compress(filtered))
    if case == "zlib_corrupt":
        return _rechunk(host_data.encode_png(samples, 2, 8), b"IDAT", b"\x78\x9c\xff\xff\xff")
    if case == "bad_filter":
        filtered = b"".join(b"\x07" + r.astype(np.uint8).tobytes() for r in samples)
        return _rechunk(host_data.encode_png(samples, 2, 8), b"IDAT", zlib.compress(filtered))
    if case == "no_iend":
        return png[:-12]
    if case == "bad_depth":
        return _rechunk(png, b"IHDR", struct.pack(">IIBBBBB", 13, 7, 4, 2, 0, 0, 0))
    if case == "interlaced":
        return host_data.encode_png(samples, 2, 8, interlace=True)
    raise ValueError(case)


CORRUPT = ["signature", "ihdr_crc", "idat_crc", "chunk_truncated", "zlib_short",
           "zlib_corrupt", "bad_filter", "no_iend", "bad_depth", "interlaced"]


@pytest.mark.parametrize("case", CORRUPT)
def test_bad_data_raises(case):
    data = _corrupt(case)
    for call in (lambda: hostops.decode_png(data, True), lambda: hostops.decode_png(data, False),
                 lambda: hostops.decode_remap(data, np.zeros(256, np.int32)),
                 lambda: hostops.decode_normalize_bgr(data, IMG_MEAN)):
        with pytest.raises(ValueError):
            call()


def test_interlaced_file_reads_through_pil():
    """PIL reads the test encoder's Adam7 file, so what the extension
    refuses is a valid file, which the datasets send to PIL."""
    rng = np.random.default_rng(2)
    samples = rng.integers(0, 256, (9, 17, 3))
    png = host_data.encode_png(samples, 2, 8, filters=(0, 1, 2, 3, 4), interlace=True)
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(png))), samples)
    with pytest.raises(ValueError, match="interlaced"):
        hostops.decode_png(png)


@pytest.mark.parametrize("kind", ["gray8", "palette8", "rgb8", "gray16", "la16"])
def test_decode_remap_matches_numpy(kind):
    rng = np.random.default_rng(5)
    png, samples = host_data.make_png(kind, rng)
    lut = rng.integers(-1, 19, 300).astype(np.int32)  # 16-bit ids past 299 take lut[299]
    want = lut[np.clip(samples[..., 0], 0, len(lut) - 1)]
    got = hostops.decode_remap(png, lut)
    assert got.dtype == np.int32 and np.array_equal(got, want)


@pytest.mark.parametrize("kind", ["rgb8", "rgba8", "palette4", "gray8", "rgb16"])
def test_decode_normalize_bgr_matches_numpy(kind):
    rng = np.random.default_rng(6)
    png, _ = host_data.make_png(kind, rng)
    rgb = host_data.pil_expected(png, True)
    want = rgb[..., ::-1].astype(np.float32) - IMG_MEAN
    got = hostops.decode_normalize_bgr(png, IMG_MEAN)
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_blur_matches_pil_and_the_jax_extension(seed):
    rng = np.random.default_rng(seed)
    assert host_data.blur_draws(rng, 40) == []
    img = rng.integers(0, 256, (23, 31, 3)).astype(np.uint8)
    for radius in (0.0, 0.123, 0.77, 0.999, 2.5):
        got = hostops.gaussian_blur(img, radius)
        want = np.asarray(Image.fromarray(img).filter(ImageFilter.GaussianBlur(radius=radius)))
        assert np.array_equal(got, want)
        if jax_hostops.available():
            assert np.array_equal(got, jax_hostops.gaussian_blur(img, radius))


def test_transform_blur_is_pils_either_way(monkeypatch):
    """``train_sync_transform``'s blur gives PIL's bytes with the extension
    and without it."""
    from maxsquareloss_torch.data.transforms import TransformConfig, train_sync_transform

    rng = np.random.default_rng(0)
    img = Image.fromarray(rng.integers(0, 256, (16, 24, 3)).astype(np.uint8))
    mask = Image.fromarray(rng.integers(0, 34, (16, 24)).astype(np.uint8))
    cfg = TransformConfig(base_size=(24, 16), crop_size=(24, 16), blur_prob=1.0)
    native = train_sync_transform(img, mask, cfg, np.random.default_rng(1))[0]
    monkeypatch.setattr(hostops, "available", lambda: False)
    pil = train_sync_transform(img, mask, cfg, np.random.default_rng(1))[0]
    assert np.array_equal(np.asarray(native), np.asarray(pil))
    assert not np.array_equal(np.asarray(pil), np.asarray(img))  # it did blur


def test_calls_count_what_went_through_the_extension(monkeypatch):
    """Each of the three decodes counts one ``decode``, the blur one
    ``blur``; the transform's PIL blur (extension off) counts nothing."""
    from maxsquareloss_torch.data.transforms import gaussian_blur

    png, _ = host_data.make_png("rgb8", np.random.default_rng(3))
    img = np.zeros((4, 5, 3), np.uint8)
    before = hostops.calls()
    hostops.decode_png(png, True)
    hostops.decode_remap(png, np.arange(256, dtype=np.int32))
    hostops.decode_normalize_bgr(png, IMG_MEAN)
    gaussian_blur(img, 0.5)
    monkeypatch.setattr(hostops, "available", lambda: False)
    gaussian_blur(img, 0.5)
    after = hostops.calls()
    assert {k: after[k] - before[k] for k in after} == {"decode": 3, "blur": 1}


def test_build_is_keyed_and_reused():
    lib = hostops.build()
    mtime = lib.stat().st_mtime_ns
    assert hostops.build.__wrapped__() == lib and lib.stat().st_mtime_ns == mtime
    assert lib.parent == hostops.BUILD_DIR and lib.name.startswith(hostops.MODULE)


def test_compile_error_raises_with_the_compilers_output(tmp_path, monkeypatch):
    broken = tmp_path / "hostops.cpp"
    broken.write_text(hostops.SOURCE.read_text() + "\nthis is not C++;\n")
    monkeypatch.setattr(hostops, "SOURCE", broken)
    monkeypatch.setattr(hostops, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed .*this is not C"):
        hostops.build.__wrapped__()


def test_unavailable_only_without_gxx_or_zlib(monkeypatch):
    import shutil

    try:
        hostops._compiler.cache_clear()
        monkeypatch.setattr(shutil, "which", lambda name: None)
        assert not hostops.available()
        with pytest.raises(RuntimeError, match="g\\+\\+ and zlib.h"):
            hostops.build.__wrapped__()
    finally:
        monkeypatch.undo()
        hostops._compiler.cache_clear()
    assert hostops.available()


@pytest.mark.parametrize("width", [1, 2, 5])
@pytest.mark.parametrize("kind", ["rgb8", "rgba8", "gray8", "rgb16", "palette4"])
def test_every_filter_at_narrow_widths(kind, width):
    """Rows shorter than a few pixels: each filter's first pixel has no left
    neighbour (the SSE2 Paeth's edge at 3- and 4-byte pixels)."""
    color, depth, c, _ = host_data.PNG_KINDS[kind]
    rng = np.random.default_rng(width)
    samples = rng.integers(0, 2 ** depth, (10, width, c))
    palette = rng.integers(0, 256, (2 ** depth, 3)) if color == 3 else None
    for f in range(5):
        png = host_data.encode_png(samples, color, depth, palette, filters=(f, 4, f))
        got = hostops.decode_png(png, False)
        assert np.array_equal(got, samples[..., 0] if c == 1 else samples), f
        assert np.array_equal(hostops.decode_png(png, True), host_data.pil_expected(png, True))
