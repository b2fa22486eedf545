"""The port's ReparamConv kernels and their paths against the JAX package.

On the CPU, float32, every tolerance stated at its test:
  * B5 ``dw_gelu_flat`` (plain version) against JAX ``dw_gelu_flat(...,
    interpret=True)``, the flat sums folded over W;
  * B6 ``rc_branch_stats`` (plain) + ``_fold_stats`` against JAX's;
  * ``rc_branch_act`` (the plain graph on CPU tensors, and the autograd
    Function, whose fused forward takes the plain kernels on CPU tensors)
    against JAX's ``custom_vjp``: t, sums, mu, var and all seven gradients;
  * B4 ``fused_reparam_conv`` (plain) against JAX ``fused_reparam_conv(...,
    interpret=True)``, and ``fused_rc_block`` against JAX's;
  * ``ReparamConv`` with 'fused' and 'packed' against JAX's in train mode,
    ``rc_remat`` on and off under 'fused', the whole TINY ``LMNet`` with
    'fused' against JAX's train step;
  * ``deploy_forward`` with rc 'flat' and 'pallas', and the backend autotune.

On a CUDA card (marker ``gpu``; skipped without one): the three kernels
against their plain versions, bitwise-repeatable sums, launch counts and
input checks. ``python -m pytest --noconftest -m gpu tests/test_torch_rc.py``
runs them there; the JAX comparisons import JAX inside the test.
"""

import numpy as np
import pytest
import torch

from lmnet_tpu_torch.ops import _build, rc_train
from lmnet_tpu_torch.ops.rc_flat import (
    dw_gelu_flat,
    dw_gelu_flat_plain,
    fold_rc_flat_weights,
    fused_rc_block,
)
from lmnet_tpu_torch.ops import rc_kernel
from lmnet_tpu_torch.ops.rc_kernel import (
    fold_rc_weights,
    fused_reparam_conv,
    fused_reparam_conv_plain,
    pack_rc_weights,
)
from lmnet_tpu_torch.ops.rc_train import (
    _fold_stats,
    _RcBranchAct,
    rc_branch_act,
    rc_branch_act_plain,
    rc_branch_stats,
    rc_branch_stats_plain,
)


def _close(got, want, rtol=1e-4, atol_rel=1e-5, name=""):
    """|got - want| <= rtol |want| + atol_rel max|want| (float32 sums in
    another order)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * np.abs(want).max(),
                               err_msg=name)


def _hwio(k: np.ndarray) -> np.ndarray:
    """OIHW depthwise (C, 1, kh, kw) -> JAX HWIO (kh, kw, 1, C)."""
    return np.ascontiguousarray(np.transpose(k, (2, 3, 1, 0)))


def _branch_inputs(seed, B, H, W, C):
    """e (B, H, W*C), the four OIHW branch kernels, gamma/beta (4, C)."""
    rng = np.random.RandomState(seed)
    e = rng.randn(B, H, W * C).astype(np.float32)
    ks = [(rng.randn(C, 1, kh, kw) * 0.3).astype(np.float32)
          for kh, kw in ((5, 5), (3, 3), (3, 1), (1, 3))]
    gamma = (1.0 + 0.1 * rng.randn(4, C)).astype(np.float32)
    beta = (0.1 * rng.randn(4, C)).astype(np.float32)
    return e, ks, gamma, beta


# --------------------------------------------------------------------------
# the kernels' functions against JAX's Pallas kernels (interpret mode)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("B,H,W,C", [(2, 16, 12, 8), (1, 5, 7, 4)])
def test_dw_gelu_flat_matches_jax_kernel(B, H, W, C):
    """t and the channel sums; rtol 1e-4 / atol 1e-5 x max (t) and 1e-4
    (sums of up to 192 values): float32 in another order."""
    import jax.numpy as jnp
    from lmnet_tpu.ops.pallas.rc_flat import _flat_weights
    from lmnet_tpu.ops.pallas.rc_flat import dw_gelu_flat as j_dw

    rng = np.random.RandomState(0)
    e = rng.randn(B, H, W * C).astype(np.float32)
    k = (rng.randn(C, 1, 5, 5) * 0.2).astype(np.float32)
    b = (rng.randn(C) * 0.1).astype(np.float32)
    jt, js = j_dw(jnp.asarray(e), _flat_weights(jnp.asarray(_hwio(k)), W),
                  jnp.tile(jnp.asarray(b), W), C, interpret=True)
    t, s = dw_gelu_flat(*map(torch.from_numpy, (e, k, b)), C)
    assert t.shape == (B, H, W * C) and s.shape == (B, C) and s.dtype == torch.float32
    _close(t.numpy(), jt, name="t")
    _close(s.numpy(), np.asarray(js).reshape(B, W, C).sum(1), 1e-4, 1e-4, "sums")
    torch.testing.assert_close(dw_gelu_flat_plain(*map(torch.from_numpy, (e, k, b)), C)[0], t)


@pytest.mark.parametrize("B,H,W,C", [(2, 8, 8, 6), (1, 16, 4, 8)])
def test_rc_branch_stats_matches_jax_kernel(B, H, W, C):
    """(4, 2, C) sums and sums of squares against JAX's (8, W*C)
    accumulators folded over W (JAX needs H % 8 == 0), and mu / var after
    ``_fold_stats``: rtol 1e-4 / atol 1e-4 x max."""
    import jax.numpy as jnp
    from lmnet_tpu.ops.pallas.rc_train import _flat_branch_weights
    from lmnet_tpu.ops.pallas.rc_train import _fold_stats as j_fold
    from lmnet_tpu.ops.pallas.rc_train import rc_branch_stats as j_stats

    e, ks, _, _ = _branch_inputs(1, B, H, W, C)
    stats8 = j_stats(jnp.asarray(e), _flat_branch_weights([jnp.asarray(_hwio(k)) for k in ks], W),
                     C, interpret=True)
    got = rc_branch_stats(torch.from_numpy(e), *map(torch.from_numpy, ks), C)
    assert got.shape == (4, 2, C) and got.dtype == torch.float32
    _close(got.numpy(), np.asarray(stats8).reshape(8, W, C).sum(1).reshape(4, 2, C), 1e-4, 1e-4)
    jmu, jvar = j_fold(stats8, B * H * W, W, C)
    mu, var = _fold_stats(got, B * H * W)
    _close(mu.numpy(), jmu, 1e-4, 1e-4, "mu")
    _close(var.numpy(), jvar, 1e-4, 1e-4, "var")


@pytest.fixture(scope="module")
def jax_branch_act():
    """JAX ``rc_branch_act`` (interpret mode) at B=2, 8x4, C=4: the inputs,
    the cotangent weights r, q, the outputs and the seven gradients of
    sum(t r) + sum(folded sums q)."""
    import jax
    import jax.numpy as jnp
    from lmnet_tpu.ops.pallas.rc_train import rc_branch_act as j_act

    B, H, W, C = 2, 8, 4, 4
    e, ks, gamma, beta = _branch_inputs(2, B, H, W, C)
    rng = np.random.RandomState(3)
    r = rng.randn(B, H, W * C).astype(np.float32)
    q = rng.randn(B, C).astype(np.float32)

    def j_loss(*a):
        t, sums, mu, var = j_act(*a, C, 1e-5, True)
        return jnp.sum(t * r) + jnp.sum(sums.reshape(B, W, C).sum(1) * q), (t, sums, mu, var)

    args = [jnp.asarray(a) for a in (e, *[_hwio(k) for k in ks], gamma, beta)]
    (_, outs), grads = jax.value_and_grad(j_loss, argnums=tuple(range(7)), has_aux=True)(*args)
    return (e, ks, gamma, beta, r, q), jax.device_get(outs), jax.device_get(grads)


@pytest.mark.parametrize("route", ["cpu graph", "autograd function"])
def test_rc_branch_act_forward_and_grads_match_jax(jax_branch_act, route):
    """t, sums (JAX's folded over W), mu, var and the gradients of e, the
    four kernels, gamma and beta for sum(t r) + sum(sums q), against JAX's
    ``rc_branch_act`` (interpret mode) and its custom_vjp. 'cpu graph' is
    what ``rc_branch_act`` runs on CPU tensors; 'autograd function' is what
    it runs on a card (the fused forward, here with the kernels' plain
    versions, and the backward through the plain graph). Forward rtol 1e-4
    / atol 1e-5 x max; gradients rtol 1e-4 / atol 1e-4 x max (batch-
    statistic BN backward in float32, another order)."""
    (e, ks, gamma, beta, r, q), (jt, jsums, jmu, jvar), jg = jax_branch_act
    B, H, W, C = 2, 8, 4, 4
    prim = [torch.from_numpy(a).requires_grad_() for a in (e, *ks, gamma, beta)]
    fn = rc_branch_act if route == "cpu graph" else _RcBranchAct.apply
    t, sums, mu, var = fn(*prim, C, 1e-5)
    assert not mu.requires_grad and not var.requires_grad
    ((t * torch.from_numpy(r)).sum() + (sums * torch.from_numpy(q)).sum()).backward()
    _close(t.detach().numpy(), jt, name="t")
    _close(sums.detach().numpy(), np.asarray(jsums).reshape(B, W, C).sum(1), name="sums")
    _close(mu.numpy(), jmu, name="mu")
    _close(var.numpy(), jvar, name="var")
    for name, p, g in zip(("e", "k5", "k3", "kv", "kh", "gamma", "beta"), prim, jg):
        want = np.asarray(g) if name in ("e", "gamma", "beta") else np.transpose(g, (3, 2, 0, 1))
        _close(p.grad.numpy(), want, 1e-4, 1e-4, name)


def _rc_deploy_variables(seed, cin, ec, cout, hw):
    """A deploy-mode ReparamConv: the JAX deploy variables (JAX's
    structural_reparam of filled train variables) and the same block as the
    port's deploy state dict under the name 'b'."""
    import jax
    from lmnet_tpu.models.blocks import ReparamConv
    from lmnet_tpu.models.lm_net import structural_reparam as j_reparam
    from test_torch_train import _filled

    from lmnet_tpu_torch import convert
    from lmnet_tpu_torch.models import structural_reparam

    v = _filled(ReparamConv(ec, cout), (1, *hw, cin), seed, False)
    sd = {}
    convert._put_rc(sd, "b", v["params"], v["batch_stats"])
    return jax.device_get(j_reparam(v)), structural_reparam(sd)


def test_fused_reparam_conv_matches_jax_kernel():
    """B4 on a 8x8 map (JAX's kernel takes H, W >= 8; 11 s at H=16 in
    interpret mode): the folded weights equal JAX's (the port adds its
    kernel's ``packed`` buffer), and the block's output matches JAX
    ``fused_reparam_conv(..., interpret=True)``; rtol 1e-4 / atol 1e-5 x
    max."""
    import jax.numpy as jnp
    from lmnet_tpu.ops.pallas.rc_kernel import fold_rc_weights as j_fold
    from lmnet_tpu.ops.pallas.rc_kernel import fused_reparam_conv as j_fused

    jv, sd = _rc_deploy_variables(4, 5, 16, 6, (8, 8))
    x = np.random.RandomState(5).randn(2, 8, 8, 5).astype(np.float32)
    jw = j_fold(jv["params"], jv["batch_stats"])
    w = fold_rc_weights(sd, "b")
    assert set(w) == set(jw) | {"packed"}
    for k in jw:
        _close(w[k].numpy(), jw[k], 1e-6, 1e-6, k)
    want = j_fused(jnp.asarray(x), jw, interpret=True)
    got = fused_reparam_conv(torch.from_numpy(x), w)
    _close(got.numpy(), want, name="out")
    torch.testing.assert_close(fused_reparam_conv_plain(torch.from_numpy(x), w), got)


@pytest.mark.parametrize("hw", [(16, 12), (5, 7)])
def test_fused_rc_block_matches_jax(hw):
    """B5's deploy block (expand + BN fold, the kernel, SE from its sums,
    pointwise + shortcut) against JAX ``fused_rc_block(..., interpret=True)``;
    rtol 1e-4 / atol 1e-5 x max."""
    import jax.numpy as jnp
    from lmnet_tpu.ops.pallas.rc_flat import fold_rc_flat_weights as j_fold
    from lmnet_tpu.ops.pallas.rc_flat import fused_rc_block as j_block

    jv, sd = _rc_deploy_variables(6, 3, 8, 4, hw)
    x = np.random.RandomState(7).randn(2, *hw, 3).astype(np.float32)
    want = j_block(jnp.asarray(x), j_fold(jv["params"], jv["batch_stats"], hw[1]),
                   interpret=True)
    got = fused_rc_block(torch.from_numpy(x), fold_rc_flat_weights(sd, "b"))
    _close(got.numpy(), want)


# --------------------------------------------------------------------------
# the train-mode block and model
# --------------------------------------------------------------------------


def _fused_on_cpu(monkeypatch, route):
    """'autograd function': the model's 'fused' block calls the autograd
    Function, as it does on a card (kernels' plain versions on CPU)."""
    if route == "autograd function":
        from lmnet_tpu_torch.models import blocks

        monkeypatch.setattr(blocks, "rc_branch_act", _RcBranchAct.apply)


@pytest.mark.parametrize("backend,route", [("fused", "cpu graph"),
                                           ("fused", "autograd function"),
                                           ("packed", "cpu graph")])
def test_reparam_conv_backends_match_jax_in_train_mode(monkeypatch, backend, route):
    """One ReparamConv (B=2, 8x8, ec=16: JAX's layout gate takes its fused
    path, W*ec = 128) with ``rc_train_backend`` 'fused' or 'packed' on both
    sides, checkpointed on the port's: output and the five BN running
    statistics rtol 1e-4 / atol 1e-5 x max; every parameter gradient and the
    input gradient as ``test_torch_train._close_grads``."""
    from lmnet_tpu.models.blocks import ReparamConv
    from test_torch_train import _block_grads, _close_grads, _filled

    from lmnet_tpu_torch import convert
    from lmnet_tpu_torch.models import blocks

    _fused_on_cpu(monkeypatch, route)
    rng = np.random.RandomState(8)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    r = rng.randn(2, 8, 8, 6).astype(np.float32)
    jb = ReparamConv(16, 6, rc_train_backend=backend)
    variables = _filled(jb, x.shape, 7, True)
    sd = {}
    convert._put_rc(sd, "b", variables["params"], variables["batch_stats"])
    tb = blocks.ReparamConv(4, 16, 6, remat=True, train_backend=backend)
    tb.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    (j_out, j_mut, j_gp, j_gx), out, gx = _block_grads(jb, variables, tb, x, r, (True,),
                                                       {"train": True})
    _close(out.numpy(), j_out, name="out")
    _close(gx.numpy(), j_gx, 1e-3, 1e-4, "dx")
    want_stats, want_grads = {}, {}
    convert._put_rc(want_stats, "b", variables["params"], j_mut["batch_stats"])
    convert._put_rc(want_grads, "b", j_gp, None)
    got = tb.state_dict()
    names = [k for k in want_stats if "running" in k]
    assert len(names) == 10
    for k in names:
        _close(got[k[2:]].numpy(), want_stats[k].numpy(), name=k)
    _close_grads({k: p.grad.numpy() for k, p in tb.named_parameters()},
                 {k: v.numpy() for k, v in want_grads.items()}, lambda k: k[2:])


@pytest.mark.parametrize("route", ["cpu graph", "autograd function"])
def test_rc_remat_changes_nothing_under_fused(monkeypatch, route):
    """``rc_remat`` on and off with 'fused': the same loss, running
    statistics (bitwise) and gradients (rtol 1e-6), so the recompute in the
    backward runs the fused forward again without a second statistics
    update."""
    from test_torch_serve import jax_variables
    from test_torch_train import _port_first_step

    _fused_on_cpu(monkeypatch, route)
    variables = jax_variables(0, 32)
    off = _port_first_step(variables, rc_remat=False, rc_train_backend="fused")
    on = _port_first_step(variables, rc_remat=True, rc_train_backend="fused")
    assert torch.equal(on[0], off[0])
    for k, v in off[2].items():
        torch.testing.assert_close(on[2][k], v, rtol=0, atol=0, msg=k)
    for k, g in off[3].items():
        torch.testing.assert_close(on[3][k], g, rtol=1e-6, atol=1e-8, msg=k)


@pytest.fixture(scope="module")
def jax_step():
    """JAX's TINY train step (nat 'xla', rc_remat off, the default branch
    graph): the variables, then (loss, logits, new batch_stats, grads)."""
    import jax
    import jax.numpy as jnp
    from lmnet_tpu.losses import segmentation_loss
    from lmnet_tpu.models import LMNet
    from test_torch_train import HW, _batches, _filled

    from conftest import TINY

    variables = _filled(LMNet(**TINY), (1, HW, HW, 3), 0)
    model = LMNet(**TINY, nat_backend="xla", rc_remat=False)

    def loss_fn(params, batch_stats, x, y):
        logits, mut = model.apply({"params": params, "batch_stats": batch_stats}, x,
                                  train=True, deterministic=True, mutable=["batch_stats"])
        return segmentation_loss(logits, y), (logits, mut["batch_stats"])

    x, y = _batches(1)[0]
    (loss, (logits, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"], jnp.asarray(x), jnp.asarray(y))
    return variables, jax.device_get((loss, logits, stats, grads))


@pytest.mark.parametrize("route", ["cpu graph", "autograd function"])
def test_lmnet_fused_train_step_matches_jax(monkeypatch, jax_step, route):
    """The TINY LMNet with ``rc_train_backend='fused'`` (and ``rc_remat``,
    the default) in train mode against JAX's train step with the branch
    graph, which computes the same function: loss rtol 1e-5, logits and the
    168 running statistics rtol 1e-4 / atol 1e-5 x max, every gradient as
    ``test_torch_train._close_grads``."""
    from test_torch_train import _close_grads, _port_first_step

    from lmnet_tpu_torch import convert

    _fused_on_cpu(monkeypatch, route)
    variables, (j_loss, j_logits, j_stats, j_grads) = jax_step
    loss, logits, sd, grads = _port_first_step(variables, rc_train_backend="fused")
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    _close(logits.numpy(), j_logits, name="logits")
    want = convert.jax_to_state_dict({"params": variables["params"], "batch_stats": j_stats})
    names = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(names) == 168
    for k in names:
        _close(sd[k].numpy(), want[k].numpy(), name=k)
    _close_grads({k: g.numpy() for k, g in grads.items()},
                 {k: w.numpy() for k, w in convert.jax_to_state_dict({"params": j_grads}).items()})


def test_rc_train_backend_is_checked():
    from conftest import TINY

    from lmnet_tpu_torch.models import LMNet

    with pytest.raises(ValueError):
        LMNet(**TINY, rc_train_backend="pallas")
    m = LMNet(**TINY, rc_train_backend="auto")
    assert {b.train_backend for b in m.modules() if hasattr(b, "train_backend")} == {"xla"}


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def deploy_pair():
    """TINY deploy variables at 32^2: JAX's and the port's."""
    import jax
    from lmnet_tpu.models import structural_reparam as j_reparam
    from test_torch_serve import jax_variables

    from lmnet_tpu_torch.convert import jax_to_state_dict
    from lmnet_tpu_torch.models import structural_reparam

    variables = jax_variables(0, 32)
    return (jax.device_get(j_reparam(variables)),
            structural_reparam(jax_to_state_dict(variables)), variables)


@pytest.mark.parametrize("rc", ["flat", "pallas"])
def test_deploy_forward_rc_backends_match_jax(deploy_pair, rc):
    """The port's deploy graph with rc 'flat' or 'pallas' against JAX
    ``deploy_forward(nat_backend='xla', interpret=True)``, fp32 at TINY 32^2,
    rtol 1e-4 / atol 1e-5 (tests/test_serve.py's bound). 'flat' is held
    against JAX's 'flat'. 'pallas' is held against JAX's 'xla', which
    computes the same function (tests/test_serve.py holds JAX's 'pallas'
    against it): JAX's 'pallas' graph takes about 100 s in interpret mode
    here, and B4 itself is held against JAX's kernel above."""
    import jax.numpy as jnp
    from conftest import TINY
    from lmnet_tpu.serve import deploy_forward

    from lmnet_tpu_torch.serve import deploy_forward as t_deploy

    jd, sd, _ = deploy_pair
    x = np.random.RandomState(1).randn(1, 32, 32, 3).astype(np.float32)
    want = np.asarray(deploy_forward(jd, jnp.asarray(x), num_heads=TINY["num_heads"],
                                     nat_backend="xla", rc_backend="xla" if rc == "pallas" else rc,
                                     interpret=True))
    with torch.no_grad():
        got = t_deploy(sd, torch.from_numpy(x), num_heads=TINY["num_heads"], rc_backend=rc)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_pick_fastest():
    from lmnet_tpu_torch.serve import pick_fastest

    t = {("xla", "flat"): 0.010, ("flat", "flat"): 0.012, ("xla", "plain"): 0.011}
    assert pick_fastest(t) == ("xla", "flat")
    assert pick_fastest({}) == ("xla", "plain")


def test_autoselect_backends_sweeps_caches_and_propagates(monkeypatch):
    """An injected time_fn: the cross product of the candidates is timed,
    the fastest pair wins, the choice and its table are cached per shape;
    a candidate that raises fails the call and caches nothing (JAX skips
    it). ``_resolve_auto`` pins a slot that is not 'auto'."""
    from lmnet_tpu_torch.serve import engine

    monkeypatch.setattr(engine, "AUTOTUNE_CACHE", {})
    calls = []

    def fake_time(rc, nat):
        calls.append((rc, nat))
        return {"xla": 0.02, "flat": 0.01}[rc] + {"flat": 0.001, "plain": 0.002}[nat]

    x = torch.zeros(1, 8, 8, 3, dtype=torch.bfloat16)
    assert engine.autoselect_backends({}, x, num_heads=2, time_fn=fake_time) == ("flat", "flat")
    assert set(calls) == {("xla", "flat"), ("xla", "plain"), ("flat", "flat"), ("flat", "plain")}
    n = len(calls)
    assert engine.autoselect_backends({}, x, num_heads=2, time_fn=fake_time) == ("flat", "flat")
    assert len(calls) == n
    ((choice, table),) = engine.AUTOTUNE_CACHE.values()
    assert choice == ("flat", "flat") and table[("flat", "flat")] == pytest.approx(0.011)

    def broken(rc, nat):
        if rc == "flat":
            raise RuntimeError("rc_dw_gelu launch failed")
        return 0.01

    y = torch.zeros(1, 16, 16, 3, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="launch failed"):
        engine.autoselect_backends({}, y, num_heads=2, time_fn=broken)
    assert len(engine.AUTOTUNE_CACHE) == 1

    calls.clear()
    monkeypatch.setattr(engine, "autoselect_backends",
                        lambda dv, x, h, rc_candidates, nat_candidates, natt_int8: (
                            calls.append((rc_candidates, nat_candidates)) or ("flat", "plain")))
    assert engine._resolve_auto({}, x, 2, "auto", "plain") == ("flat", "plain")
    assert engine._resolve_auto({}, x, 2, "pallas", "auto") == ("flat", "plain")
    assert calls == [(("xla", "flat"), ("plain",)), (("pallas",), ("flat", "plain"))]


def test_serving_evaluate_auto_resolves_once(monkeypatch, deploy_pair):
    """``serving_evaluate(rc_backend='auto')`` times rc 'xla' and 'flat'
    (nat pinned to its 'flat' default) on the first batch with the default
    timer (a warm-up and 8 calls each, the host clock on a CPU tensor),
    keeps the choice for every batch, and gives exactly what serving with
    the chosen pair gives."""
    from conftest import TINY

    from lmnet_tpu_torch.convert import jax_to_state_dict
    from lmnet_tpu_torch.data import SyntheticDataset, make_loader
    from lmnet_tpu_torch.serve import engine

    monkeypatch.setattr(engine, "AUTOTUNE_CACHE", {})
    seen = []
    real = engine.deploy_forward

    def spy(*a, **kw):
        seen.append((kw["rc_backend"], kw["nat_backend"]))
        return real(*a, **kw)

    state = jax_to_state_dict(deploy_pair[2])
    kw = dict(num_classes=2, img_size=32, num_heads=TINY["num_heads"], device="cpu")
    loader = make_loader(SyntheticDataset(4, 32, "val", seed=3), 2)
    monkeypatch.setattr(engine, "deploy_forward", spy)
    loss, metrics = engine.serving_evaluate(state, loader, rc_backend="auto", **kw)
    ((choice, table),) = engine.AUTOTUNE_CACHE.values()
    assert set(table) == {("xla", "flat"), ("flat", "flat")}
    assert choice == engine.pick_fastest(table)
    assert seen[-2:] == [choice, choice] and len(seen) == 2 * 9 + 2
    monkeypatch.setattr(engine, "deploy_forward", real)
    want = engine.serving_evaluate(state, make_loader(SyntheticDataset(4, 32, "val", seed=3), 2),
                                   rc_backend=choice[0], nat_backend=choice[1], **kw)
    assert (loss, metrics) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1, 3, 8])
def test_aligned_copies_only_a_view_off_16_bytes(dtype, offset):
    """``_build.aligned``, which every kernel wrapper applies to what it
    copies in 16-byte units: a view whose data starts on 16 bytes comes back
    as it is; any other becomes an equal contiguous copy that does."""
    base = torch.arange(64, dtype=dtype)
    view = base[offset:offset + 32].view(4, 8)
    got = _build.aligned(view)
    if view.data_ptr() % 16 == 0:
        assert got is view
    else:
        assert got.data_ptr() % 16 == 0 and got.is_contiguous() and torch.equal(got, view)


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


# (B, H, W, C): LM-Net's E at its stages, a 28^2 map with E=20, a 5x5 map,
# a W=7 strip, and more channels than one block takes (256)
DW_SHAPES = [(2, 16, 16, 24), (1, 32, 32, 192), (2, 28, 28, 20), (1, 5, 5, 48), (2, 16, 7, 96),
             (1, 6, 5, 300)]


def _bf16_bound(want):
    """One bf16 rounding of the stored value (2^-9 relative), with margin."""
    return 2**-8 * want.abs() + 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C", DW_SHAPES)
def test_dw_gelu_kernel_matches_plain_on_card(cuda, dtype, B, H, W, C):
    """B5 against ``dw_gelu_flat_plain`` on the same (bf16-rounded) inputs
    in float32: t f32 within 1e-5 (1 + |ref|), bf16 within one rounding of
    the stored value (2^-9 relative, with margin); sums (from the float32 t
    in both) within 1e-5 of sum|t| per channel; two calls bitwise equal."""
    g = torch.Generator().manual_seed(B * H + C)
    e = torch.randn(B, H, W * C, generator=g).to(cuda, dtype)
    k = (torch.randn(C, 1, 5, 5, generator=g) * 0.2).to(cuda)
    b = (torch.randn(C, generator=g) * 0.1).to(cuda)
    before = dw_gelu_flat.launches
    t, s = dw_gelu_flat(e, k, b, C)
    t2, s2 = dw_gelu_flat(e, k, b, C)
    torch.cuda.synchronize()
    assert dw_gelu_flat.launches == before + 2
    assert t.dtype == dtype and s.shape == (B, C) and s.dtype == torch.float32
    wt, ws = dw_gelu_flat_plain(e.float(), k, b, C)
    bound = 1e-5 * (1 + wt.abs()) if dtype == torch.float32 else _bf16_bound(wt)
    assert bool(((t.float() - wt).abs() <= bound).all())
    scale = wt.abs().reshape(B, H * W, C).sum(1)
    assert bool(((s - ws).abs() <= 1e-5 * scale + 1e-6).all())
    assert torch.equal(t, t2) and torch.equal(s, s2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C", DW_SHAPES)
def test_rc_stats_kernel_matches_plain_on_card(cuda, dtype, B, H, W, C):
    """B6 against ``rc_branch_stats_plain`` on the same inputs: each sum
    within 1e-5 of the matching sum of |y| (or y^2); two calls bitwise
    equal."""
    e, ks, _, _ = _branch_inputs(C, B, H, W, C)
    e = torch.from_numpy(e).to(cuda, dtype)
    ks = [torch.from_numpy(k).to(cuda) for k in ks]
    before = rc_branch_stats.launches
    got = rc_branch_stats(e, *ks, C)
    again = rc_branch_stats(e, *ks, C)
    torch.cuda.synchronize()
    assert rc_branch_stats.launches == before + 2 and torch.equal(got, again)
    want = rc_branch_stats_plain(e, *ks, C)
    ys = rc_train._branch_outputs(e, [k.float() for k in ks], C, torch.float32)
    scale = torch.stack([torch.stack([y.abs().sum(dim=(0, 2, 3)), y.square().sum(dim=(0, 2, 3))])
                         for y in ys])
    assert bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())


# (B, H, W, Cin, E, Cout): the five ReparamConv shapes of LM-Net (at small
# maps), a 28^2 map with E=20, a 5x5 map and a W=7 strip
RC_SHAPES = [(2, 16, 16, 3, 24, 12), (2, 16, 16, 12, 24, 12), (1, 16, 16, 24, 48, 24),
             (1, 8, 8, 48, 96, 48), (1, 8, 8, 96, 192, 96), (2, 28, 28, 8, 20, 8),
             (1, 5, 5, 24, 48, 24), (2, 16, 7, 12, 24, 12)]


def _rc_weights(seed, Cin, E, Cout, device):
    g = torch.Generator().manual_seed(seed)

    def n(*shape, s=1.0):
        return (torch.randn(*shape, generator=g) * s).to(device)

    w = dict(we=n(E, Cin, s=Cin**-0.5), be=n(E, s=0.1), kdw=n(25, E, s=0.2), bdw=n(E, s=0.1),
             fc1_w=n(E // 4, E, s=E**-0.5), fc1_b=n(E // 4, s=0.1),
             fc2_w=n(E, E // 4, s=(E // 4) ** -0.5), fc2_b=n(E, s=0.1),
             wp=n(Cout, E, s=E**-0.5), bp=n(Cout, s=0.1), wsc=n(Cout, Cin, s=Cin**-0.5),
             bsc=n(Cout, s=0.1))
    w["packed"] = pack_rc_weights(w)
    return w


def check_bf16_two_ways(got, x, w):
    """bf16 B4 output ``got`` on bf16 ``x``, held two ways (the bounds of
    chip_smoke.py's phase 10): against the plain version that rounds at the
    kernel's points within 2^-7 max|ref| (one rounding of the stored y and
    float32 sums in another order), and against the float32 plain version
    on the same bf16 x within 2x that version's distance from it + 2^-8
    max|ref|. Returns the two distances."""
    want_r = fused_reparam_conv_plain(x, w).float()
    want_f = fused_reparam_conv_plain(x.float(), w)
    m = want_f.abs().max().item()
    d_r = (got.float() - want_r).abs().max().item()
    d_f = (got.float() - want_f).abs().max().item()
    dist = (want_r - want_f).abs().max().item()
    assert d_r <= 2**-7 * m, (d_r, m)
    assert d_f <= 2 * dist + 2**-8 * m, (d_f, dist, m)
    return d_r, d_f


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,Cin,E,Cout", RC_SHAPES)
def test_fused_reparam_conv_kernel_matches_plain_on_card(cuda, dtype, B, H, W, Cin, E, Cout):
    """B4 against ``fused_reparam_conv_plain`` on the same inputs: f32
    within 1e-4 (1 + max|ref|) (sums of up to 192 + 96 products in another
    order); bf16 (tensor-core products) the two ways of
    ``check_bf16_two_ways``."""
    w = _rc_weights(Cin * E, Cin, E, Cout, cuda)
    x = torch.randn(B, H, W, Cin, generator=torch.Generator().manual_seed(H)).to(cuda, dtype)
    before = fused_reparam_conv.launches
    got = fused_reparam_conv(x, w)
    torch.cuda.synchronize()
    assert fused_reparam_conv.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, H, W, Cout)
    if dtype == torch.bfloat16:
        check_bf16_two_ways(got, x, w)
    else:
        want = fused_reparam_conv_plain(x, w)
        assert bool(((got - want).abs() <= 1e-4 * (1 + want.abs().max())).all())
    # a permuted (non-contiguous) input is copied, not refused
    xp = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert torch.equal(fused_reparam_conv(xp, w), got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,Cin,E,Cout", [RC_SHAPES[2], RC_SHAPES[5]])
def test_fused_reparam_conv_phase1_sums_repeat_bitwise(cuda, dtype, B, H, W, Cin, E, Cout):
    """B4's phase 1 twice on the same inputs: bitwise-equal (B, E) channel
    sums (per-tile partials reduced in a fixed order), within 1e-5 of the
    sum of |t| per channel of the plain version's float32 t (on the same
    rounded weights)."""
    w = _rc_weights(E, Cin, E, Cout, cuda)
    x = torch.randn(B, H, W, Cin, generator=torch.Generator().manual_seed(W)).to(cuda, dtype)
    s1 = rc_kernel.rc_phase1(x, w)
    s2 = rc_kernel.rc_phase1(x, w)
    torch.cuda.synchronize()
    assert torch.equal(s1, s2) and s1.shape == (B, E)
    mat = (lambda k: w[k].to(dtype).float())
    e = torch.nn.functional.hardswish(torch.nn.functional.linear(x.float(), mat("we"), w["be"]))
    t = torch.nn.functional.gelu(torch.nn.functional.conv2d(
        e.permute(0, 3, 1, 2), w["kdw"].t().reshape(E, 1, 5, 5), w["bdw"], padding=2, groups=E),
        approximate="tanh")
    assert bool(((s1 - t.sum(dim=(2, 3))).abs() <= 1e-5 * t.abs().sum(dim=(2, 3)) + 1e-6).all())


@pytest.mark.gpu
def test_rc_branch_act_on_card_launches_both_kernels(cuda):
    """One forward through ``rc_branch_act`` launches B6 and B5 once each;
    t, sums, mu, var agree with the plain graph in float32 (rtol 1e-4 / atol
    1e-4) and so do the gradients, which the backward takes from it."""
    B, H, W, C = 2, 12, 10, 24
    e, ks, gamma, beta = _branch_inputs(9, B, H, W, C)
    prim = [torch.from_numpy(a).to(cuda).requires_grad_() for a in (e, *ks, gamma, beta)]
    s0, d0 = rc_branch_stats.launches, dw_gelu_flat.launches
    out = rc_branch_act(*prim, C)
    assert (rc_branch_stats.launches, dw_gelu_flat.launches) == (s0 + 1, d0 + 1)
    want = rc_branch_act_plain(*prim, C)
    for a, b in zip(out, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    r = torch.randn_like(out[0])
    g_fused = torch.autograd.grad((out[0] * r).sum() + out[1].sum(), prim)
    g_plain = torch.autograd.grad((want[0] * r).sum() + want[1].sum(), prim)
    for a, b in zip(g_fused, g_plain):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_rc_kernels_reject_what_they_do_not_take(cuda):
    e, ks, _, _ = _branch_inputs(0, 1, 8, 8, 16)
    e = torch.from_numpy(e).to(cuda)
    ks = [torch.from_numpy(k).to(cuda) for k in ks]
    k5, b = ks[0], torch.zeros(16, device=cuda)
    with pytest.raises(ValueError):  # fp16 is not a kernel dtype
        dw_gelu_flat(e.half(), k5, b, 16)
    with pytest.raises(ValueError):  # non-contiguous e
        dw_gelu_flat(e.transpose(1, 2).contiguous().transpose(1, 2), k5, b, 16)
    with pytest.raises(ValueError):  # a kernel of the wrong shape
        rc_branch_stats(e, ks[1], ks[0], ks[2], ks[3], 16)
    with pytest.raises(ValueError):  # a bias of the wrong shape
        dw_gelu_flat(e, k5, torch.zeros(15, device=cuda), 16)
    w = _rc_weights(0, 4, 8, 4, cuda)
    with pytest.raises(ValueError):  # x's channels do not fit we
        fused_reparam_conv(torch.zeros(1, 8, 8, 5, device=cuda), w)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["B4", "B5", "B6"])
def test_rc_kernels_take_an_offset_view(cuda, kernel, dtype):
    """The activation as a contiguous view whose data starts 2 or 4 bytes
    off 16 (the kernels copy it in units of up to 16 bytes): the same
    result as on an aligned copy, one launch."""
    B, H, W, C = 2, 16, 16, 24
    e, ks, _, _ = _branch_inputs(7, B, H, W, C)
    e = torch.from_numpy(e).to(cuda, dtype)
    ks = [torch.from_numpy(k).to(cuda) for k in ks]
    w = _rc_weights(3, C, 48, C, cuda)
    run, counted = {
        "B4": (lambda a: fused_reparam_conv(a.view(B, H, W, C), w), fused_reparam_conv),
        "B5": (lambda a: dw_gelu_flat(a, ks[0], torch.full((C,), 0.1, device=cuda), C),
               dw_gelu_flat),
        "B6": (lambda a: rc_branch_stats(a, *ks, C), rc_branch_stats),
    }[kernel]
    view = torch.empty(e.numel() + 1, dtype=dtype, device=cuda)[1:].view(e.shape)
    view.copy_(e)
    assert view.is_contiguous() and view.data_ptr() % 16
    want = run(e)
    before = counted.launches
    got = run(view)
    torch.cuda.synchronize()
    assert counted.launches == before + 1
    if kernel == "B5":  # (t, sums)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    else:
        assert torch.equal(got, want)
