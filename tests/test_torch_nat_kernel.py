"""The port's B3 kernel (``nat_backend='pallas'``) against the JAX package.

On the CPU, float32: ``neighborhood_attention_pallas`` (the plain NAT on CPU
tensors) against JAX's ``_nat_forward(..., interpret=True)`` at the shapes of
``tests/test_pallas_nat.py``, its gradients against ``jax.grad`` through JAX's
``custom_vjp``, and the TINY ``LMNet(nat_backend='pallas')`` train step
against JAX's, with JAX's kernel run in interpret mode.

On a CUDA card (marker ``gpu``; skipped without one): the kernel against the
plain NAT and against B1, its launch count, its backward and its input
checks. ``python -m pytest --noconftest -m gpu tests/test_torch_nat_kernel.py``
runs them there; the JAX comparisons import JAX inside the test.
"""

import functools

import numpy as np
import pytest
import torch

from lmnet_tpu_torch.ops.nat import neighborhood_attention
from lmnet_tpu_torch.ops.nat_flat import nat_flat
from lmnet_tpu_torch.ops.nat_kernel import (
    neighborhood_attention_pallas,
    neighborhood_attention_pallas_plain,
)


def _qkv(seed, B, H, W, C, heads):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, W, C).astype(np.float32) for _ in range(3))
    return q, k, v, (0.1 * rng.randn(heads, 5, 5)).astype(np.float32)


# (B, H, W, heads, C): the four shapes of tests/test_pallas_nat.py
JAX_SHAPES = [(1, 16, 16, 12, 12), (2, 8, 16, 3, 12), (1, 16, 64, 12, 24), (1, 8, 128, 4, 12)]


@pytest.mark.parametrize("B,H,W,heads,C", JAX_SHAPES)
def test_plain_b3_matches_jax_kernel(B, H, W, heads, C):
    """rtol 2e-5 / atol 2e-6 (tests/test_pallas_nat.py's bound)."""
    import jax.numpy as jnp
    from lmnet_tpu.ops.pallas.nat_kernel import _nat_forward

    q, k, v, rpb = _qkv(0, B, H, W, C, heads)
    want = _nat_forward(*map(jnp.asarray, (q, k, v, rpb)), 3, interpret=True)
    before = neighborhood_attention_pallas.launches
    got = neighborhood_attention_pallas(*map(torch.from_numpy, (q, k, v, rpb)))
    assert neighborhood_attention_pallas.launches == before  # no kernel on the CPU
    assert got.shape == (B, H, W, C) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-6)


def test_b3_gradients_match_jax_custom_vjp():
    """dq, dk, dv, d_rpb of sum(out * r) against jax.grad through
    ``neighborhood_attention_pallas`` (its backward is the XLA vjp); float32,
    rtol 1e-4 / atol 1e-5."""
    import jax
    import jax.numpy as jnp
    from lmnet_tpu.ops.pallas import nat_kernel

    q, k, v, rpb = _qkv(1, 2, 4, 6, 8, 2)  # H < 8: JAX's forward takes its XLA path
    r = np.random.RandomState(2).randn(2, 4, 6, 8).astype(np.float32)
    want = jax.grad(
        lambda *a: jnp.sum(nat_kernel.neighborhood_attention_pallas(*a, 3) * r),
        argnums=(0, 1, 2, 3))(*map(jnp.asarray, (q, k, v, rpb)))
    prim = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, rpb)]
    (neighborhood_attention_pallas(*prim) * torch.from_numpy(r)).sum().backward()
    for name, p, w in zip(("dq", "dk", "dv", "d_rpb"), prim, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_b3_rejects_other_kernel_sizes_and_shapes():
    q, k, v, rpb = map(torch.from_numpy, _qkv(3, 1, 5, 5, 4, 2))
    with pytest.raises(ValueError):
        neighborhood_attention_pallas(q, k, v, rpb, kernel_size=5)
    with pytest.raises(ValueError):
        neighborhood_attention_pallas(q, k[:, :4], v, rpb)
    with pytest.raises(ValueError):
        neighborhood_attention_pallas(q, k, v, torch.zeros(3, 5, 5))


@pytest.fixture(scope="module")
def jax_pallas_step():
    """JAX's TINY train step with ``nat_backend='pallas'`` (its kernel in
    interpret mode: the Pallas TPU kernel has no other CPU mode) and
    ``rc_remat`` off: the variables, then (loss, grads)."""
    import jax
    import jax.numpy as jnp
    from conftest import TINY
    from lmnet_tpu.losses import segmentation_loss
    from lmnet_tpu.models import LMNet
    from lmnet_tpu.ops.pallas import nat_kernel
    from test_torch_train import HW, _batches, _filled

    variables = _filled(LMNet(**TINY), (1, HW, HW, 3), 0)
    model = LMNet(**TINY, nat_backend="pallas", rc_remat=False)

    def loss_fn(params, batch_stats, x, y):
        logits, _ = model.apply({"params": params, "batch_stats": batch_stats}, x,
                                train=True, deterministic=True, mutable=["batch_stats"])
        return segmentation_loss(logits, y)

    x, y = _batches(1)[0]
    real = nat_kernel._nat_forward
    nat_kernel._nat_forward = functools.partial(real, interpret=True)
    try:
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            variables["params"], variables["batch_stats"], jnp.asarray(x), jnp.asarray(y))
        out = jax.device_get((loss, grads))
    finally:
        nat_kernel._nat_forward = real
    return variables, out


def test_lmnet_pallas_train_step_matches_jax(jax_pallas_step):
    """The TINY ``LMNet(nat_backend='pallas')`` train step against JAX's with
    the same backend: loss rtol 1e-5, every gradient as
    ``test_torch_train._close_grads``."""
    from test_torch_train import _close_grads, _port_first_step

    from lmnet_tpu_torch import convert

    variables, (j_loss, j_grads) = jax_pallas_step
    loss, _, _, grads = _port_first_step(variables, nat_backend="pallas")
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    _close_grads({k: g.numpy() for k, g in grads.items()},
                 {k: w.numpy() for k, w in convert.jax_to_state_dict({"params": j_grads}).items()})


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (B, H, W, heads, head_dim): LM-Net's four head_dims, H=W=3, head_dim 3, a
# narrow map, head_dim 16, a map that ends mid-tile, C=384
CARD_SHAPES = [(2, 16, 16, 12, 1), (1, 32, 40, 12, 2), (2, 16, 16, 12, 4), (1, 8, 8, 12, 8),
               (2, 3, 3, 2, 2), (1, 28, 28, 12, 3), (2, 16, 4, 12, 4), (1, 5, 7, 1, 16),
               (1, 13, 37, 3, 1), (1, 6, 6, 12, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,heads,hd", CARD_SHAPES)
def test_b3_kernel_matches_plain_and_b1_on_card(cuda, dtype, B, H, W, heads, hd):
    """B3 against the plain NAT on the same (bf16-rounded) inputs in float32
    (f32 within 1e-5 abs; bf16 within 2^-8 |ref| + 1e-4, one rounding of the
    stored result) and against B1 on the same inputs (f32 1e-5; bf16 two
    roundings, 2^-7 |B1| + 1e-4)."""
    C = heads * hd
    q, k, v, rpb = (torch.from_numpy(a).to(cuda) for a in _qkv(H * W + hd, B, H, W, C, heads))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    before = neighborhood_attention_pallas.launches
    got = neighborhood_attention_pallas(q, k, v, rpb)
    torch.cuda.synchronize()
    assert neighborhood_attention_pallas.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = neighborhood_attention(q.float(), k.float(), v.float(), rpb, 3)
    b1 = nat_flat(*(t.reshape(B, H, W * C) for t in (q, k, v)), rpb, heads, C, W)
    b1 = b1.reshape(B, H, W, C).float()
    err, err_b1 = (got.float() - want).abs(), (got.float() - b1).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-5 and err_b1.max().item() <= 1e-5
    else:
        assert bool((err <= 2**-8 * want.abs() + 1e-4).all()), err.max().item()
        assert bool((err_b1 <= 2**-7 * b1.abs() + 1e-4).all()), err_b1.max().item()


@pytest.mark.gpu
def test_b3_backward_on_card_is_autograd_of_plain(cuda):
    """One forward and backward: one kernel launch, and the gradients equal
    autograd of the plain NAT (float32, rtol 1e-5 / atol 1e-6)."""
    q, k, v, rpb = (torch.from_numpy(a).to(cuda) for a in _qkv(5, 2, 9, 11, 24, 12))
    r = torch.randn(2, 9, 11, 24, generator=torch.Generator().manual_seed(0)).to(cuda)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, rpb)]
    before = neighborhood_attention_pallas.launches
    got = torch.autograd.grad((neighborhood_attention_pallas(*leaves) * r).sum(), leaves)
    assert neighborhood_attention_pallas.launches == before + 1
    plain = [t.clone().requires_grad_() for t in (q, k, v, rpb)]
    want = torch.autograd.grad((neighborhood_attention_pallas_plain(*plain) * r).sum(), plain)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_b3_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v, rpb = (torch.from_numpy(a).to(cuda) for a in _qkv(6, 1, 4, 4, 4, 2))
    with pytest.raises(ValueError):  # fp16 is not a kernel dtype
        neighborhood_attention_pallas(q.half(), k.half(), v.half(), rpb)
    with pytest.raises(ValueError):  # k on another dtype
        neighborhood_attention_pallas(q, k.bfloat16(), v, rpb)
    with pytest.raises(ValueError):  # non-contiguous q
        neighborhood_attention_pallas(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, rpb)
    with pytest.raises(ValueError):  # rpb not float32
        neighborhood_attention_pallas(q, k, v, rpb.bfloat16())
    with pytest.raises(ValueError):  # fewer than 3 rows
        neighborhood_attention_pallas(q[:, :2].contiguous(), k[:, :2].contiguous(),
                                      v[:, :2].contiguous(), rpb)


# (B, H, W, heads, head_dim) at which each B3 variant runs: 'vec' with the
# 2-D map (bf16 C = 12: the model's stage, ragged tiles; float32 C = 6, 8
# bytes a thread), with the 3-D map and more tiles than blocks (the ring
# turns), with head chunks (C = 512 and 256, ragged); 'generic' at head_dim
# 3 and 16, in bf16 at a C = 12 row of 312 bytes that no map strides, and
# in bf16 at C = 6, which no thread group divides
VARIANT_SHAPES = [(16, 256, 256, 12, 1), (2, 33, 34, 12, 1), (16, 128, 128, 12, 2),
                  (1, 9, 11, 64, 8), (1, 12, 9, 128, 2), (2, 7, 13, 12, 1), (1, 28, 28, 12, 3),
                  (1, 5, 7, 1, 16), (1, 8, 8, 6, 1), (1, 7, 12, 3, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,heads,hd", VARIANT_SHAPES)
def test_b3_each_variant_matches_plain_on_card(cuda, dtype, B, H, W, heads, hd):
    """The plan's variant against the plain NAT on the same inputs (f32
    within 1e-5 abs; bf16 within 2^-8 |ref| + 1e-4), one launch without a
    gradient."""
    from lmnet_tpu_torch.ops.nat_flat import _group_channels
    from lmnet_tpu_torch.ops.nat_kernel import b3_plan

    C, es = heads * hd, 4 if dtype == torch.float32 else 2
    plan = b3_plan(B, H, W, heads, hd, dtype)
    group = hd in (1, 2, 4, 8) and _group_channels(hd, C, es) > 0
    mapped = C * es % 16 == 0 or W * C * es % 16 == 0  # a 3-D or a 2-D map strides it
    assert plan["variant"] == ("vec" if group and mapped else "generic")
    q, k, v, rpb = (torch.from_numpy(a).to(cuda) for a in _qkv(W + hd, B, H, W, C, heads))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    before = neighborhood_attention_pallas.launches
    with torch.inference_mode():
        got = neighborhood_attention_pallas(q, k, v, rpb)
    torch.cuda.synchronize()
    assert neighborhood_attention_pallas.launches == before + 1
    want = neighborhood_attention(q.float(), k.float(), v.float(), rpb, 3)
    err = (got.float() - want).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-5
    else:
        assert bool((err <= 2**-8 * want.abs() + 1e-4).all()), err.max().item()
