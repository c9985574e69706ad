"""The port's fused max-square losses (their plain versions on the CPU)
against the retired Pallas kernels in interpret mode and against the JAX
package's ``ops/losses.py`` of the softmax. Seeded numpy inputs; the same
IW weights, from the JAX histogram, go to both sides. Tolerances, as the
Pallas kernels' own tests: forward rel 1e-4 (fp32 sums over up to 40k
terms in another order), gradients atol 1e-5."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from experiments.retired_pallas import fused_loss as pallas
from maxsquareloss_tpu.ops.histogram import class_histogram, iw_class_weights
from maxsquareloss_tpu.ops.losses import iw_max_square_loss, max_square_loss
from maxsquareloss_torch.kernels import fused_loss
from maxsquareloss_torch.kernels.fused_loss import (
    fused_iw_max_square_loss,
    fused_max_square_loss,
)

C = 19
SHAPES = [(2, 16, 32), (1, 6, 16), (1, 37, 53)]  # the last ragged, as on the card


def _logits(shape, seed=0):
    return np.random.default_rng(seed).normal(0, 3, (*shape, C)).astype(np.float32)


def _weights(logits, label=None):
    """(N, C) IW weights from the label's (or the argmax's) histogram."""
    argpred = jnp.argmax(jax.nn.softmax(jnp.asarray(logits), axis=-1), axis=-1).astype(jnp.int32)
    count = argpred if label is None else jnp.asarray(label)
    return np.array(iw_class_weights(class_histogram(count, C), 0.2))


def _jax_loss(reference, logits, weights, label):
    """(value, grad wrt the logits) of the JAX reference."""
    if reference == "pallas_interpret":
        with pltpu.force_tpu_interpret_mode():
            if weights is None:
                return jax.value_and_grad(pallas.fused_max_square_loss)(jnp.asarray(logits))
            return jax.value_and_grad(
                lambda x: pallas.fused_iw_max_square_loss(x, jnp.asarray(weights))
            )(jnp.asarray(logits))
    if weights is None:
        fn = lambda x: max_square_loss(jax.nn.softmax(x, axis=-1))  # noqa: E731
    else:
        lab = None if label is None else jnp.asarray(label)
        fn = lambda x: iw_max_square_loss(jax.nn.softmax(x, axis=-1), lab, num_classes=C)  # noqa: E731
    return jax.value_and_grad(fn)(jnp.asarray(logits))


def _port_loss(logits, weights):
    x = torch.from_numpy(logits.copy()).requires_grad_(True)
    if weights is None:
        loss = fused_max_square_loss(x)
    else:
        w = torch.from_numpy(weights.copy()).requires_grad_(True)
        loss = fused_iw_max_square_loss(x, w)
    loss.backward()
    if weights is not None:
        assert w.grad is None  # the weights get no gradient (the kernel's None)
    return loss, x.grad


@pytest.mark.parametrize("reference", ["pallas_interpret", "ops"])
@pytest.mark.parametrize("variant", ["maxsquare", "iw_argmax", "iw_guidance"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_port_matches_jax(shape, variant, reference):
    logits = _logits(shape)
    label = None
    if variant == "iw_guidance":
        label = np.random.default_rng(1).integers(-1, C, shape).astype(np.int32)
    weights = None if variant == "maxsquare" else _weights(logits, label)
    want, want_grad = _jax_loss(reference, logits, weights, label)
    before = (fused_iw_max_square_loss.launches, fused_max_square_loss.backward_launches)
    loss, grad = _port_loss(logits, weights)
    # CPU tensors never reach a kernel
    assert (fused_iw_max_square_loss.launches, fused_max_square_loss.backward_launches) == before
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert loss.item() == pytest.approx(float(want), rel=1e-4)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), atol=1e-5)


def test_ties_take_the_first_max():
    """Two classes tie exactly at the max on every pixel: the pixel weight
    is the first one's, as the Pallas kernel's iota-min and jnp.argmax."""
    logits = _logits((1, 4, 8), seed=2)
    logits[..., 3] = logits[..., 11] = logits.max() + 1.0
    weights = np.linspace(0.1, 1.0, C, dtype=np.float32)[None]  # w[3] != w[11]
    with pltpu.force_tpu_interpret_mode():
        want = float(pallas.fused_iw_max_square_loss(jnp.asarray(logits), jnp.asarray(weights)))
    loss, _ = _port_loss(logits, weights)
    assert loss.item() == pytest.approx(want, rel=1e-5)
    p = torch.softmax(torch.from_numpy(logits), dim=-1)
    first = -(p.square().sum(-1) * weights[0, 3]).sum().item() / C
    last = -(p.square().sum(-1) * weights[0, 11]).sum().item() / C
    assert loss.item() == pytest.approx(first, rel=1e-5) != pytest.approx(last, rel=1e-5)


@pytest.mark.parametrize(
    "make,match",
    [
        (lambda x, w: (x.double(), w), "float32"),
        (lambda x, w: (x.transpose(1, 2), w), "contiguous"),
        (lambda x, w: (x, w[:, :5]), "weights have shape"),
        (lambda x, w: (torch.zeros(1, 2, 2, 33), torch.zeros(1, 33)), "classes"),
        (lambda x, w: (x[0], w), "4-D"),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(make, match):
    x = torch.from_numpy(_logits((1, 4, 8)))
    w = torch.ones(1, C)
    x, w = make(x, w)
    with pytest.raises((TypeError, ValueError), match=match):
        fused_iw_max_square_loss(x, w)


def _tile_image_indices(p0: int, hw: int, tiles: int) -> list[int]:
    """The image index of every pixel of a block's ``tiles`` tiles, for a
    block whose first pixel is ``p0`` and images of ``hw`` pixels: the
    kernel's arithmetic (``ImageIndex`` in the .cu), restated. One division
    at the block's first pixel; then a compare per pixel where an image
    holds at least a tile (a tile crosses at most one image boundary), and
    a division of a number below ``hw + THREADS`` where it holds less.
    Equal to ``[pix // hw for pix in range(p0, p0 + tiles * fused_loss.THREADS)]``."""
    n0, r0 = divmod(p0, hw)
    out = []
    for _ in range(tiles):
        for t in range(fused_loss.THREADS):
            off = r0 + t
            out.append(n0 + (off >= hw) if hw >= fused_loss.THREADS else n0 + off // hw)
        r0 += fused_loss.THREADS
        if hw >= fused_loss.THREADS:
            if r0 >= hw:
                r0 -= hw
                n0 += 1
        else:
            n0 += r0 // hw
            r0 %= hw
    return out


@pytest.mark.parametrize("hw", [1, 7, 99, 255, 256, 257, 1961, 2048, 5000])
@pytest.mark.parametrize("block", [0, 1, 3])
def test_tile_image_index_matches_integer_division(hw, block):
    """The kernel's image index per tile (one division at the block's first
    pixel, then compares, or a small division where an image holds less
    than a tile) against ``pix // (H*W)``, for H*W below, at and above the
    256-pixel tile."""
    tiles = fused_loss.PX_PER_BLOCK // fused_loss.THREADS
    p0 = block * fused_loss.PX_PER_BLOCK
    got = _tile_image_indices(p0, hw, tiles)
    assert got == [pix // hw for pix in range(p0, p0 + fused_loss.PX_PER_BLOCK)]


def test_block_granularity_is_a_whole_number_of_tiles():
    """The forward's partials, one per PX_PER_BLOCK pixels, fix the sum's
    order by the shape alone; a block walks whole tiles."""
    assert fused_loss.PX_PER_BLOCK == 2048 and fused_loss.THREADS == 256
    x = torch.zeros(4, 37, 53, 19)
    pixels, hw, c, blocks = fused_loss._grid(x)
    assert (pixels, hw, c, blocks) == (4 * 37 * 53, 37 * 53, 19, -(-4 * 37 * 53 // 2048))
