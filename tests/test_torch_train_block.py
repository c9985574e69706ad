"""The port's training bottleneck (``FusedBottleneckFn``: the emit forward's
plain version on the CPU and the adjoint-chain backward) against
``jax.grad`` of the JAX package's live ``_bottleneck`` and of the retired
Pallas fused block in interpret mode (its ``emit=True`` forward and XLA
backward), and in the masked-canvas mode against ``_bottleneck(...,
mask=...)``. Seeded numpy inputs, a random cotangent, NHWC on both sides.
Tolerance rtol 1e-4, atol 1e-5: fp32 sums over up to N*H*W pixels (the
weight gradients) in another order."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from experiments.retired_pallas.fused_block import fused_bottleneck as pallas_fused
from maxsquareloss_tpu.models.deeplabv2 import _bottleneck
from maxsquareloss_torch.kernels import fused_block
from maxsquareloss_torch.kernels.fused_block import (
    FusedBottleneckFn,
    fused_bottleneck,
    fused_bottleneck_emit,
)
from tests.test_torch_fused_block import CASES, _bn_args, _make_case

CONVS = ("conv1", "conv2", "conv3")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread: these steps are small, so more threads gain
    little, and the suite's workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_grads(reference, p, f, x, cot, d, mask=None):
    """(out, dx, {conv: dw}) from jax.grad of sum(block(x) * cot); ``mask``
    (N, H, W, 1) the live block's canvas mask."""
    bn = [jnp.asarray(v) for v in _bn_args(f)]
    jf = {k: {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in f.items()}

    def block(x, ws):
        if reference == "bottleneck":
            return _bottleneck({k: {"w": ws[k]} for k in CONVS}, jf, x, stride=1, dilation=d,
                               mask=None if mask is None else jnp.asarray(mask))
        return pallas_fused(x, *(ws[k] for k in CONVS), *bn, d)

    def loss(x, ws):
        return jnp.sum(block(x, ws) * cot)

    ws = {k: jnp.asarray(v) for k, v in p.items()}
    with pltpu.force_tpu_interpret_mode():
        out = block(jnp.asarray(x), ws)
        dx, dws = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), ws)
    return np.asarray(out), np.asarray(dx), {k: np.asarray(v) for k, v in dws.items()}


@pytest.mark.parametrize("reference", ["bottleneck", "pallas_interpret"])
@pytest.mark.parametrize("n,h,w,cin,cmid,d", CASES)
def test_train_block_grads_match_jax(n, h, w, cin, cmid, d, reference):
    rng = np.random.default_rng(3)
    p, f, x = _make_case(rng, n, h, w, cin, cmid)
    cot = rng.normal(size=x.shape).astype(np.float32)
    want_out, want_dx, want_dw = _jax_grads(reference, p, f, x, cot, d)

    xt = torch.from_numpy(x.copy()).permute(0, 3, 1, 2).requires_grad_(True)
    ws = [torch.from_numpy(p[k].copy()).requires_grad_(True) for k in CONVS]
    bn = [torch.from_numpy(v) for v in _bn_args(f)]
    before = fused_bottleneck_emit.launches
    out = FusedBottleneckFn.apply(xt, *ws, *bn, d)
    assert fused_bottleneck_emit.launches == before  # CPU: the plain version
    assert out.is_contiguous(memory_format=torch.channels_last)
    (out * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()

    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), want_out, **tol)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), want_dx, **tol)
    for k, wt in zip(CONVS, ws):
        assert wt.grad.shape == wt.shape
        np.testing.assert_allclose(wt.grad.numpy(), want_dw[k], **tol, err_msg=k)


def _canvas(n, h, w):
    """Per-image valid extents on an (h, w) canvas (the first image fills it
    when there are two) and the (N, H, W, 1) 0/1 mask they give."""
    small = (max(1, h - 4), max(1, w - 5))
    valid = [(h, w), small][-n:]
    mask = np.zeros((n, h, w, 1), np.float32)
    for i, (vh, vw) in enumerate(valid):
        mask[i, :vh, :vw] = 1.0
    return torch.tensor(valid, dtype=torch.int32), mask


@pytest.mark.parametrize("n,h,w,cin,cmid,d", CASES)
def test_masked_train_block_grads_match_jax(n, h, w, cin, cmid, d):
    """The masked-canvas block: out and the gradients of x and the three
    kernels against jax.grad of the live ``_bottleneck(..., mask=...)``, so
    the unchanged adjoint chain over the emitted (masked) h1 is the masked
    block's gradient; the eval forward gives the same out; the emitted h1 is
    exactly 0 in the pad region."""
    rng = np.random.default_rng(6)
    p, f, x = _make_case(rng, n, h, w, cin, cmid)
    cot = rng.normal(size=x.shape).astype(np.float32)
    valid, mask = _canvas(n, h, w)
    assert (mask == 0).any()
    want_out, want_dx, want_dw = _jax_grads("bottleneck", p, f, x, cot, d, mask)

    xt = torch.from_numpy(x.copy()).permute(0, 3, 1, 2).requires_grad_(True)
    ws = [torch.from_numpy(p[k].copy()).requires_grad_(True) for k in CONVS]
    bn = [torch.from_numpy(v) for v in _bn_args(f)]
    out = FusedBottleneckFn.apply(xt, *ws, *bn, d, valid)
    (out * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()

    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), want_out, **tol)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), want_dx, **tol)
    for k, wt in zip(CONVS, ws):
        np.testing.assert_allclose(wt.grad.numpy(), want_dw[k], **tol, err_msg=k)

    args = (xt.detach(), *(w.detach() for w in ws), *bn, d, valid)
    torch.testing.assert_close(fused_bottleneck(*args), out.detach(), rtol=0, atol=0)
    _, h1, _ = fused_bottleneck_emit(*args)
    h1 = h1.permute(0, 2, 3, 1).numpy()
    assert (h1[mask[..., 0] == 0] == 0.0).all()
    assert (h1[mask[..., 0] == 1] > 0).any()


@pytest.mark.parametrize("n,h,w,cin,cmid,d", CASES[:2])
def test_emit_outputs_are_the_chain_intermediates(n, h, w, cin, cmid, d):
    """(out, h1, h2) of the emit forward: out as the eval forward's, h1 and
    h2 as relu(bn1(conv1 x)) and relu(bn2(conv2 h1)) of the JAX layers."""
    from maxsquareloss_tpu.models.layers import conv2d, frozen_bn

    p, f, x = _make_case(np.random.default_rng(4), n, h, w, cin, cmid)
    args = [torch.from_numpy(x).permute(0, 3, 1, 2)]
    args += [torch.from_numpy(p[k]) for k in CONVS] + [torch.from_numpy(v) for v in _bn_args(f)]
    out, h1, h2 = fused_bottleneck_emit(*args, d)
    torch.testing.assert_close(out, fused_bottleneck(*args, d), rtol=0, atol=0)
    j1 = jax.nn.relu(frozen_bn(conv2d(jnp.asarray(x), jnp.asarray(p["conv1"])), **f["bn1"]))
    j2 = jax.nn.relu(frozen_bn(conv2d(j1, jnp.asarray(p["conv2"]), padding=d, dilation=d),
                               **f["bn2"]))
    for got, want in ((h1, j1), (h2, j2)):
        assert got.shape == (n, cmid, h, w)
        assert got.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_backward_takes_strided_weight_views():
    """The model hands in HWIO views of OIHW conv weights: the gradient
    arrives at the OIHW parameter, equal to the contiguous-input one."""
    p, f, x = _make_case(np.random.default_rng(5), 1, 7, 9, 32, 8)
    bn = [torch.from_numpy(v) for v in _bn_args(f)]
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    oihw = [torch.from_numpy(p[k]).permute(3, 2, 0, 1).contiguous().requires_grad_(True)
            for k in CONVS]
    FusedBottleneckFn.apply(xt, *(w.permute(2, 3, 1, 0) for w in oihw), *bn, 2).square().sum().backward()
    hwio = [torch.from_numpy(p[k]).requires_grad_(True) for k in CONVS]
    fused_block.fused_bottleneck_reference(xt, *hwio, *bn, 2).square().sum().backward()
    for a, b in zip(oihw, hwio):
        torch.testing.assert_close(a.grad.permute(2, 3, 1, 0), b.grad, rtol=1e-5, atol=1e-6)
