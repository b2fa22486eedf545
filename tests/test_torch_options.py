"""The port's model options against the JAX package, at TINY: ``gelu_exact``
(the erf GELU in every block), ``rc_remat='branches'`` (keep each
ReparamConv's expand conv output, recompute the rest) and ``natt_remat``
(recompute each NeighborhoodTransformer block, with the forward's dropout
masks).

JAX variables are filled from a numpy seed (``test_torch_train._filled``)
and converted; the options add no parameter, so the converted state dict
loads into every option's model. One jitted JAX whole-model
``value_and_grad`` with the three options serves the module.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import TINY
from test_torch_train import HW, _batches, _close, _close_grads, _filled

from lmnet_tpu_torch import convert
from lmnet_tpu_torch.losses import segmentation_loss as t_seg
from lmnet_tpu_torch.models import LMNet as TLMNet
from lmnet_tpu_torch.models import blocks as t_blocks

OPTIONS = dict(gelu_exact=True, rc_remat="branches", natt_remat=True)


@pytest.fixture(scope="module")
def variables():
    from lmnet_tpu.models import LMNet

    return _filled(LMNet(**TINY), (1, HW, HW, 3), 0)


def _port(variables, **kw):
    m = TLMNet(**TINY, **kw)
    m.load_state_dict(convert.jax_to_state_dict(variables), strict=True)
    return m


def _step(model, x, y, deterministic=True, seed=None):
    """One train-mode forward and backward: (loss, logits, state dict after
    the forward, {name: grad}, the generator's state after the step)."""
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    logits = model(torch.from_numpy(x), train=True, deterministic=deterministic, generator=gen)
    loss = t_seg(logits, torch.from_numpy(y))
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return (loss.detach(), logits.detach(), model.state_dict(), grads,
            None if gen is None else gen.get_state())


def test_options_add_no_parameter_and_the_converter_still_holds(variables):
    """Every option's model has the default's state-dict names and shapes,
    and the converted JAX variables load into it with strict=True."""
    want = {k: v.shape for k, v in TLMNet(**TINY).state_dict().items()}
    m = _port(variables, **OPTIONS)
    assert {k: v.shape for k, v in m.state_dict().items()} == want


def test_whole_model_step_with_the_options_matches_jax(variables):
    """JAX's ``LMNet(gelu_exact=True, rc_remat='branches', natt_remat=True)``
    train-mode loss and gradients (dropout off) against the port's with the
    same options on converted weights: logits rtol 1e-4 / atol 1e-5 x max,
    loss rtol 1e-5, every gradient as ``test_torch_train._close_grads``,
    and the BN running statistics as the logits."""
    from lmnet_tpu.losses import segmentation_loss
    from lmnet_tpu.models import LMNet

    model = LMNet(**TINY, nat_backend="xla", **OPTIONS)

    def loss_fn(params, x, y):
        logits, mut = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, x,
            train=True, deterministic=True, mutable=["batch_stats"],
        )
        return segmentation_loss(logits, y), (logits, mut["batch_stats"])

    x, y = _batches(1)[0]
    (j_loss, (j_logits, j_stats)), j_grads = jax.device_get(
        jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"], jnp.asarray(x), jnp.asarray(y)))
    loss, logits, sd, grads, _ = _step(_port(variables, **OPTIONS), x, y)
    _close(logits.numpy(), j_logits, 1e-4, 1e-5, "logits")
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    _close_grads({k: g.numpy() for k, g in grads.items()},
                 {k: w.numpy() for k, w in convert.jax_to_state_dict({"params": j_grads}).items()})
    want = convert.jax_to_state_dict({"params": variables["params"], "batch_stats": j_stats})
    for k in (k for k in want if "running" in k):
        _close(sd[k].numpy(), want[k].numpy(), 1e-4, 1e-5, k)


def test_gelu_exact_eval_logits_match_jax(variables):
    """Eval-mode logits (running statistics) of ``gelu_exact=True``: float32,
    rtol 1e-4 / atol 1e-5 x max; and the erf GELU really differs from the
    default tanh form here."""
    from lmnet_tpu.models import LMNet

    x = np.random.RandomState(3).randn(2, HW, HW, 3).astype(np.float32)
    want = jax.jit(lambda v, xx: LMNet(**TINY, nat_backend="xla", gelu_exact=True).apply(
        v, xx, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = _port(variables, gelu_exact=True)(torch.from_numpy(x))
        tanh = _port(variables)(torch.from_numpy(x))
    _close(got.numpy(), np.asarray(want), 1e-4, 1e-5, "logits")
    assert (got - tanh).abs().max() > 1e-5


@pytest.mark.parametrize("backend", ["xla", "packed"])
def test_rc_remat_branches_gives_the_same_grads_and_running_stats(variables, backend):
    """'branches' (the expand conv's output kept, the rest recomputed), True
    and False give the same loss, gradients and running statistics, under
    the plain branch graph and the packed one: the recompute does not update
    the statistics a second time."""
    x, y = _batches(1)[0]
    off = _step(_port(variables, rc_remat=False, rc_train_backend=backend), x, y)
    for remat in ("branches", True):
        on = _step(_port(variables, rc_remat=remat, rc_train_backend=backend), x, y)
        assert torch.equal(on[0], off[0]), remat
        for k, v in off[2].items():
            torch.testing.assert_close(on[2][k], v, rtol=0, atol=0, msg=k)
        for k, g in off[3].items():
            torch.testing.assert_close(on[3][k], g, rtol=1e-6, atol=1e-8, msg=k)


def test_rc_remat_branches_keeps_only_the_expand_output():
    """Under 'branches' the expand conv runs once per step (outside the
    checkpoint), the expand BN and the branches twice (forward and
    recompute); under True everything runs twice."""
    calls = {}

    def count(name):
        def hook(*_):
            calls[name] = calls.get(name, 0) + 1
        return hook

    x = torch.randn(2, 8, 8, 4)
    for remat, want in (("branches", {"expand": 1, "large": 2}), (True, {"expand": 2, "large": 2}),
                        (False, {"expand": 1, "large": 1})):
        b = t_blocks.ReparamConv(4, 8, 4, remat=remat)
        with torch.no_grad():
            for m in b.modules():
                if hasattr(m, "init_"):
                    m.init_(torch.Generator().manual_seed(0))
        calls.clear()
        b.expand_conv[0].register_forward_hook(count("expand"))
        b.large_conv.conv.register_forward_hook(count("large"))
        b(x.requires_grad_(), train=True).square().sum().backward()
        assert calls == want, (remat, calls)


def test_natt_remat_with_dropout_equals_no_remat(variables):
    """``natt_remat`` with dropout on, from the same generator seed: the same
    loss, gradients and running statistics as without it, and the generator
    ends in the same state (the masks are drawn once, before the
    checkpoint); with dropout on, the loss is not the deterministic one."""
    x, y = _batches(1)[0]
    off = _step(_port(variables), x, y, deterministic=False, seed=7)
    on = _step(_port(variables, natt_remat=True), x, y, deterministic=False, seed=7)
    assert torch.equal(on[0], off[0])
    assert torch.equal(on[4], off[4])
    for k, v in off[2].items():
        torch.testing.assert_close(on[2][k], v, rtol=0, atol=0, msg=k)
    for k, g in off[3].items():
        torch.testing.assert_close(on[3][k], g, rtol=1e-6, atol=1e-8, msg=k)
    det = _step(_port(variables), x, y)
    assert not torch.equal(det[0], off[0])


def test_natt_remat_recomputes_the_block_once():
    """A NATT block under ``remat`` in train mode runs its attention twice
    a step (forward and recompute); in eval mode, or without ``remat``,
    once."""
    for remat, train, want in ((True, True, 2), (True, False, 1), (False, True, 1)):
        b = t_blocks.NeighborhoodTransformer(8, 2, "plain", remat=remat)
        with torch.no_grad():
            for m in b.modules():
                if hasattr(m, "init_"):
                    m.init_(torch.Generator().manual_seed(0))
        n = []
        b.att1.register_forward_hook(lambda *_: n.append(1))
        x = torch.randn(1, 6, 6, 8, requires_grad=True)
        b(x, False, torch.Generator().manual_seed(0), train).sum().backward()
        assert len(n) == want, (remat, train, len(n))


def test_fused_rc_backend_refuses_gelu_exact():
    """B5 and B6 compute the tanh GELU: 'fused' with gelu_exact raises,
    naming them; 'xla' and 'packed' take it."""
    with pytest.raises(ValueError, match="B5 and B6"):
        t_blocks.ReparamConv(4, 8, 4, train_backend="fused", gelu_exact=True)
    with pytest.raises(ValueError, match="B5 and B6"):
        TLMNet(**TINY, gelu_exact=True, rc_train_backend="fused")
    for backend in ("auto", "xla", "packed"):
        TLMNet(**TINY, gelu_exact=True, rc_train_backend=backend)
