"""The port's B7 kernel (the flat 2x upsample) and the upsample backend
switch against the JAX package.

On the CPU, float32: ``upsample2x_flat`` (its plain version on CPU tensors)
and its backward against JAX ``upsample2x_flat(x, True)`` and its vjp, at the
shapes of ``tests/test_resize.py`` and the shapes JAX sends to its einsum
path; the backend switch of ``ops/resize.py``; and the TINY deploy graph
with the flat backend on in both packages.

On a CUDA card (marker ``gpu``; skipped without one): the kernel against the
plain version, its launch count, its backward and its input checks.
``python -m pytest --noconftest -m gpu tests/test_torch_upsample.py`` runs
them there; the JAX comparisons import JAX inside the test.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lmnet_tpu_torch.ops import resize
from lmnet_tpu_torch.ops.upsample_flat import upsample2x_flat, upsample2x_flat_plain

# tests/test_resize.py's four kernel shapes, then the two it sends to einsum
JAX_SHAPES = [(2, 16, 16, 8), (1, 8, 32, 4), (1, 16, 24, 16), (1, 8, 48, 8), (1, 5, 7, 3),
              (1, 8, 9, 5)]


@pytest.mark.parametrize("shape", JAX_SHAPES)
def test_b7_and_its_backward_match_jax(shape):
    """Forward and vjp against JAX ``upsample2x_flat(x, True)``: float32,
    rtol 1e-5 / atol 1e-5 (tests/test_resize.py's bound)."""
    import jax
    import jax.numpy as jnp
    from lmnet_tpu.ops.pallas.upsample_flat import upsample2x_flat as j_up

    B, H, W, C = shape
    rng = np.random.RandomState(0)
    x = rng.randn(B, H, W, C).astype(np.float32)
    g = rng.randn(B, 2 * H, 2 * W, C).astype(np.float32)
    want, vjp = jax.vjp(lambda t: j_up(t, True), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    before = upsample2x_flat.launches
    got = upsample2x_flat(xt)
    assert upsample2x_flat.launches == before  # the CPU path launches no kernel
    assert got.shape == (B, 2 * H, 2 * W, C) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-5, atol=1e-5)


def test_b7_plain_equals_torch_interpolate_at_one_pixel_maps():
    """H or W = 1 (a_0 = b_0 = 0): the plain lerp against F.interpolate,
    float32, rtol 1e-6 / atol 1e-6."""
    for shape in [(2, 1, 5, 3), (1, 4, 1, 2), (1, 1, 1, 4)]:
        x = torch.from_numpy(np.random.RandomState(1).randn(*shape).astype(np.float32))
        want = torch.nn.functional.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                                               mode="bilinear", align_corners=True)
        torch.testing.assert_close(upsample2x_flat_plain(x), want.permute(0, 2, 3, 1),
                                   rtol=1e-6, atol=1e-6)


def test_upsample_backend_switch(monkeypatch):
    """``LMNET_UPSAMPLE_BACKEND`` is read at import into
    ``resize.UPSAMPLE_BACKEND`` ('einsum' by default); 'flat' dispatches to
    ``upsample2x_flat``; an unknown value raises (JAX takes 'einsum')."""
    x = torch.from_numpy(np.random.RandomState(2).randn(1, 6, 5, 3).astype(np.float32))
    calls = []
    monkeypatch.setattr(resize, "upsample2x_flat", lambda t: calls.append(t) or "flat")
    monkeypatch.setattr(resize, "UPSAMPLE_BACKEND", "einsum")
    assert resize.upsample2x_align_corners(x).shape == (1, 12, 10, 3) and not calls
    monkeypatch.setattr(resize, "UPSAMPLE_BACKEND", "flat")
    assert resize.upsample2x_align_corners(x) == "flat" and calls[0] is x
    monkeypatch.setattr(resize, "UPSAMPLE_BACKEND", "pallas")
    with pytest.raises(ValueError):
        resize.upsample2x_align_corners(x)
    env = {k: v for k, v in os.environ.items() if k != "LMNET_UPSAMPLE_BACKEND"}
    for value, want in ((None, "einsum"), ("flat", "flat")):
        extra = {} if value is None else {"LMNET_UPSAMPLE_BACKEND": value}
        out = subprocess.run(
            [sys.executable, "-c", "from lmnet_tpu_torch.ops import resize; "
                                   "print(resize.UPSAMPLE_BACKEND)"],
            env={**env, **extra}, capture_output=True, text=True, timeout=120)
        assert out.stdout.strip() == want, out.stderr


def test_deploy_forward_with_flat_upsample_matches_jax(monkeypatch):
    """The TINY deploy graph with the flat upsample in both packages (JAX's
    module attribute patched, its kernel in interpret mode), float32 at
    32^2, rtol 1e-4 / atol 1e-5 (tests/test_serve.py's bound)."""
    import functools

    import jax.numpy as jnp
    from conftest import TINY
    from lmnet_tpu.models import structural_reparam as j_reparam
    from lmnet_tpu.ops import resize as j_resize
    from lmnet_tpu.ops.pallas import upsample_flat as j_upflat
    from lmnet_tpu.serve import deploy_forward
    from test_torch_serve import jax_variables

    from lmnet_tpu_torch.convert import jax_to_state_dict
    from lmnet_tpu_torch.models import structural_reparam
    from lmnet_tpu_torch.serve import deploy_forward as t_deploy

    variables = jax_variables(0, 32)
    x = np.random.RandomState(1).randn(1, 32, 32, 3).astype(np.float32)
    monkeypatch.setattr(j_resize, "_UPSAMPLE2X_BACKEND", "flat")
    monkeypatch.setattr(j_upflat, "upsample2x_flat",
                        functools.partial(j_upflat.upsample2x_flat, interpret=True))
    want = np.asarray(deploy_forward(j_reparam(variables), jnp.asarray(x),
                                     num_heads=TINY["num_heads"], nat_backend="xla",
                                     rc_backend="xla"))
    calls = []
    monkeypatch.setattr(resize, "UPSAMPLE_BACKEND", "flat")
    monkeypatch.setattr(resize, "upsample2x_flat",
                        lambda t: calls.append(t.shape) or upsample2x_flat(t))
    with torch.no_grad():
        got = t_deploy(structural_reparam(jax_to_state_dict(variables)), torch.from_numpy(x),
                       num_heads=TINY["num_heads"], nat_backend="plain")
    assert len(calls) == 7  # up1..up4 and three skip inputs
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# (B, H, W, C): LM-Net's four upsample widths, one-pixel maps, odd sizes,
# channel counts that are not a multiple of the 16-byte vector
CARD_SHAPES = [(2, 16, 16, 192), (2, 32, 32, 96), (1, 64, 64, 48), (1, 128, 128, 24),
               (2, 1, 1, 8), (1, 1, 7, 3), (2, 5, 9, 12), (1, 8, 9, 5), (3, 7, 3, 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C", CARD_SHAPES)
def test_b7_kernel_matches_plain_on_card(cuda, dtype, B, H, W, C):
    """B7 against ``upsample2x_flat_plain`` on the same input: float32 within
    1e-6 (1 + |ref|) (the kernel fuses multiply-adds); bf16 within one
    rounding of the stored value, 2^-8 |ref| + 1e-6."""
    x = torch.randn(B, H, W, C, generator=torch.Generator().manual_seed(H * W + C))
    x = x.to(cuda, dtype)
    before = upsample2x_flat.launches
    got = upsample2x_flat(x)
    torch.cuda.synchronize()
    assert upsample2x_flat.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, 2 * H, 2 * W, C)
    want = upsample2x_flat_plain(x.float())
    err = (got.float() - want).abs()
    bound = 1e-6 * (1 + want.abs()) if dtype == torch.float32 else 2**-8 * want.abs() + 1e-6
    assert bool((err <= bound).all()), err.max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b7_kernel_takes_an_offset_view(cuda, dtype):
    """x as a contiguous view whose data starts 2 or 4 bytes off 16 (the
    kernel loads x in 16-byte units): the same output as on an aligned
    copy, one launch."""
    x = torch.randn(2, 16, 16, 24, generator=torch.Generator().manual_seed(2)).to(cuda, dtype)
    view = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)[1:].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16
    want = upsample2x_flat(x)
    before = upsample2x_flat.launches
    got = upsample2x_flat(view)
    torch.cuda.synchronize()
    assert upsample2x_flat.launches == before + 1 and torch.equal(got, want)


@pytest.mark.gpu
def test_b7_backward_on_card_is_the_adjoint(cuda):
    """One forward and backward: one kernel launch; the gradient equals
    autograd of the plain version (float32, rtol 1e-5 / atol 1e-6), and a
    permuted input is copied, not refused."""
    x = torch.randn(2, 8, 6, 16, generator=torch.Generator().manual_seed(0)).to(cuda)
    g = torch.randn(2, 16, 12, 16, generator=torch.Generator().manual_seed(1)).to(cuda)
    xt = x.clone().requires_grad_()
    before = upsample2x_flat.launches
    (got,) = torch.autograd.grad(upsample2x_flat(xt), xt, g)
    assert upsample2x_flat.launches == before + 1
    xp = x.clone().requires_grad_()
    (want,) = torch.autograd.grad(upsample2x_flat_plain(xp), xp, g)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    xv = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert torch.equal(upsample2x_flat(xv), upsample2x_flat(x))


@pytest.mark.gpu
def test_b7_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros(1, 4, 4, 8, device=cuda)
    with pytest.raises(ValueError):  # fp16 is not a kernel dtype
        upsample2x_flat(x.half())
    with pytest.raises(ValueError):  # not NHWC
        upsample2x_flat(x[0])


# (B, H, W, C) at which each B7 variant runs: 'tma' at a model width, a
# one-row map and channel chunks past 256 (a zero-filled tail); 'generic' at
# chip_smoke.py phase 14's odd pixels (6, 24 and 40 bytes in bf16)
VARIANT_SHAPES = [(16, 128, 128, 24), (2, 1, 9, 16), (1, 9, 11, 384), (2, 6, 5, 320),
                  (2, 5, 7, 3), (3, 9, 13, 12), (1, 7, 3, 20)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C", VARIANT_SHAPES)
def test_b7_each_variant_matches_plain_on_card(cuda, dtype, B, H, W, C):
    """The plan's variant ('tma' exactly where a pixel's bytes are a
    multiple of 16) against the plain version, with check_up's bounds:
    float32 within 1e-6 (1 + |ref|), bf16 within 2^-8 |ref| + 1e-6."""
    from lmnet_tpu_torch.ops.upsample_flat import upsample_plan

    es = 4 if dtype == torch.float32 else 2
    assert upsample_plan(B, H, W, C, dtype)["variant"] == ("tma" if C * es % 16 == 0
                                                            else "generic")
    x = torch.randn(B, H, W, C, generator=torch.Generator().manual_seed(C + W)).to(cuda, dtype)
    with torch.inference_mode():
        got = upsample2x_flat(x)
    torch.cuda.synchronize()
    want = upsample2x_flat_plain(x.float())
    err = (got.float() - want).abs()
    bound = 1e-6 * (1 + want.abs()) if dtype == torch.float32 else 2**-8 * want.abs() + 1e-6
    assert got.dtype == dtype and bool((err <= bound).all()), err.max().item()
