"""The PyTorch port's training slice against the JAX package, at TINY.

Float32 on both sides, dropout off (JAX ``deterministic=True``; the port's
dropout rate patched to 0, which makes its dropout the identity). JAX
variables are shaped with ``jax.eval_shape`` (no init compile) and filled
from a numpy seed; the port loads them through ``lmnet_tpu_torch.convert``,
which also maps JAX's gradients onto the port's parameter names. The JAX
model runs ``nat_backend='xla'`` (its flat Pallas NAT cannot run on the CPU)
and ``rc_remat=False`` (the same function, cheaper to compile). One jitted
whole-model ``value_and_grad`` serves the module: the step, the 3-step
trajectory (with JAX's own AdamW and schedule) and the running statistics.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import TINY
from lmnet_tpu_torch import convert
from lmnet_tpu_torch.losses import dice_loss as t_dice
from lmnet_tpu_torch.losses import segmentation_loss as t_seg
from lmnet_tpu_torch.metrics import ConfusionAccumulator
from lmnet_tpu_torch.models import LMNet as TLMNet
from lmnet_tpu_torch.models import blocks as t_blocks
from lmnet_tpu_torch.train import (
    cosine_epoch_schedule,
    create_train_state,
    evaluate,
    train_one_epoch,
    train_step,
)

HW, B = 32, 2
HEADS = TINY["num_heads"]
EPOCHS, STEPS_PER_EPOCH = 2, 2  # the 3-step trajectory crosses an epoch: the lr changes


def _filled(module, x_shape, seed, *args):
    """``module``'s variables shaped by eval_shape, filled from a numpy seed
    (kernels ~ N(0, 1/fan_in), BN scale ~ U(0.5, 1.5), small biases)."""
    shapes = jax.eval_shape(
        lambda k: module.init(k, jnp.zeros(x_shape), *args), jax.random.key(0)
    )
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        a = {
            "var": lambda: rng.uniform(0.5, 2.0, shape),
            "mean": lambda: rng.normal(0.0, 0.5, shape),
            "scale": lambda: rng.uniform(0.5, 1.5, shape),
            "bias": lambda: rng.normal(0.0, 0.1, shape),
            "kernel": lambda: rng.normal(0.0, 1.0, shape) / np.sqrt(np.prod(shape[:-1])),
            "rpb": lambda: rng.normal(0.0, 0.3, shape),
        }[name]()
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _batches(n, seed=1):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rng.randn(B, HW, HW, 3).astype(np.float32)
        out.append((x, (x.mean(-1) > 0.3).astype(np.int32)))
    return out


def _close(got, want, rtol, atol_rel, name="", floor=0.0):
    """Elementwise |got - want| <= rtol * |want| + atol_rel * max|want| + floor."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * np.abs(want).max() + floor, err_msg=name)


def _close_grads(got, want, name_map=lambda k: k):
    """Every gradient within rtol 1e-3 + 1e-4 x its own max + 1e-6 x the
    largest gradient of the set: float32 sums in another order, through
    batch-statistic BN backward. The floor covers gradients that are zero in
    exact arithmetic (the bias of a conv feeding a train-mode BN), which
    both sides give as float32 noise of ~1e-8."""
    assert set(got) == {name_map(k) for k in want}
    floor = 1e-6 * max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for k, w in want.items():
        _close(got[name_map(k)], w, 1e-3, 1e-4, k, floor)


@pytest.fixture
def no_dropout(monkeypatch):
    """Dropout rate 0: the port's dropout keeps everything and scales by 1."""
    monkeypatch.setattr(t_blocks, "DROPOUT", 0.0)


@pytest.fixture(scope="module")
def variables():
    from lmnet_tpu.models import LMNet

    return _filled(LMNet(**TINY), (1, HW, HW, 3), 0)


@pytest.fixture(scope="module")
def jax_grad():
    """The one whole-model JAX compile: (params, batch_stats, x, y) ->
    ((loss, (train-mode logits, new batch_stats)), grads), with JAX's
    training loss (CE weight [1,4], smoothing 0.001, + Dice [1,4])."""
    from lmnet_tpu.losses import segmentation_loss
    from lmnet_tpu.models import LMNet

    model = LMNet(**TINY, nat_backend="xla", rc_remat=False)

    def loss_fn(params, batch_stats, x, y):
        logits, mut = model.apply(
            {"params": params, "batch_stats": batch_stats}, x,
            train=True, deterministic=True, mutable=["batch_stats"],
        )
        return segmentation_loss(logits, y), (logits, mut["batch_stats"])

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


@pytest.fixture(scope="module")
def jax_first_step(variables, jax_grad):
    x, y = _batches(1)[0]
    (loss, (logits, stats)), grads = jax_grad(
        variables["params"], variables["batch_stats"], jnp.asarray(x), jnp.asarray(y)
    )
    return jax.device_get((loss, logits, stats, grads))


def _port_model(variables, **kw):
    m = TLMNet(**TINY, **kw)
    m.load_state_dict(convert.jax_to_state_dict(variables), strict=True)
    return m


def _port_first_step(variables, **kw):
    """One train-mode forward + backward of the port (dropout off):
    (loss, logits, state dict after the forward, {name: grad})."""
    m = _port_model(variables, **kw)
    x, y = _batches(1)[0]
    logits = m(torch.from_numpy(x), train=True, deterministic=True)
    loss = t_seg(logits, torch.from_numpy(y))
    loss.backward()
    grads = {n: p.grad.clone() for n, p in m.named_parameters()}
    return loss.detach(), logits.detach(), m.state_dict(), grads


def test_converter_maps_a_params_only_tree_onto_the_parameters(variables):
    """Without batch_stats the converter gives exactly the port's parameter
    names (how JAX gradients are mapped below)."""
    sd = convert.jax_to_state_dict({"params": variables["params"]})
    named = dict(TLMNet(**TINY).named_parameters())
    assert set(sd) == set(named)
    assert all(sd[k].shape == named[k].shape for k in sd)


def test_train_forward_logits_and_running_stats_match_jax(variables, jax_first_step):
    """Train-mode logits (BN on batch statistics) and the BN running
    statistics after the step: float32, rtol 1e-4 / atol 1e-5 x max (the
    same arithmetic in another order; batch statistics of 2x32x32 maps)."""
    _, j_logits, j_stats, _ = jax_first_step
    _, logits, sd, _ = _port_first_step(variables)
    _close(logits.numpy(), j_logits, 1e-4, 1e-5, "logits")
    want = convert.jax_to_state_dict({"params": variables["params"], "batch_stats": j_stats})
    names = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(names) == 2 * (16 * 5 + 4)  # 16 ReparamConvs x 5 BNs + 4 skip BNs
    for k in names:
        _close(sd[k].numpy(), want[k].numpy(), 1e-4, 1e-5, k)


def test_train_step_loss_and_every_gradient_match_jax(variables, jax_first_step):
    """CE + Dice and the gradient of every parameter against JAX's, mapped
    through the converter: loss rtol 1e-5, gradients as ``_close_grads``."""
    j_loss, _, _, j_grads = jax_first_step
    loss, _, _, grads = _port_first_step(variables)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    _close_grads({k: g.numpy() for k, g in grads.items()},
                 {k: w.numpy() for k, w in convert.jax_to_state_dict({"params": j_grads}).items()})


def test_three_step_loss_trajectory_matches_jax(variables, jax_grad, no_dropout):
    """Three train_step calls of the port (AdamW, per-epoch cosine schedule
    across an epoch boundary, BN running stats) against JAX's gradient plus
    its own make_optimizer update from the same init and batches. The
    losses agree to rtol 1e-4 (JAX's torch-reference trajectory test allows
    5e-3), and so do the running statistics after the third step."""
    import optax
    from lmnet_tpu.train.engine import make_optimizer

    batches = _batches(3, seed=2)
    tx = make_optimizer(epochs=EPOCHS, steps_per_epoch=STEPS_PER_EPOCH)

    @jax.jit  # one compile; optax op by op compiles every op apart (~40 s)
    def update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    params, stats = variables["params"], variables["batch_stats"]
    opt_state = jax.jit(tx.init)(params)
    j_losses = []
    for x, y in batches:
        (loss, (_, stats)), grads = jax_grad(params, stats, jnp.asarray(x), jnp.asarray(y))
        params, opt_state = update(grads, opt_state, params)
        j_losses.append(float(loss))

    state = create_train_state(_port_model(variables), (B, HW, HW, 3), device="cpu",
                               epochs=EPOCHS, steps_per_epoch=STEPS_PER_EPOCH)
    cm = ConfusionAccumulator.init(2)
    t_losses = []
    for x, y in batches:
        state, loss, cm = train_step(state, torch.from_numpy(x), torch.from_numpy(y).long(), cm)
        t_losses.append(float(loss))
    assert state.step == 3 and int(cm.sum()) == 3 * B * HW * HW
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    assert t_losses[1] != t_losses[0]
    sd = state.model.state_dict()
    want = convert.jax_to_state_dict(jax.device_get({"params": params, "batch_stats": stats}))
    for k in ("conv1.0.expand_conv.1.running_var", "skip2.fuse_conv.1.running_mean",
              "dconv4.1.hor_conv.bn.running_var", "natt1.att1.rpb", "gft.attention.qkv.weight"):
        _close(sd[k].numpy(), want[k].numpy(), 1e-3, 1e-4, k)


def test_rc_remat_gives_the_same_grads_and_running_stats(variables):
    """torch.utils.checkpoint around every ReparamConv changes nothing: the
    same loss, gradients and running statistics, so the recompute in the
    backward does not update the statistics a second time."""
    off = _port_first_step(variables, rc_remat=False)
    on = _port_first_step(variables, rc_remat=True)
    assert torch.equal(on[0], off[0])
    for k, v in off[2].items():
        torch.testing.assert_close(on[2][k], v, rtol=0, atol=0, msg=k)
    for k, g in off[3].items():
        torch.testing.assert_close(on[3][k], g, rtol=1e-6, atol=1e-8, msg=k)


def test_rc_remat_takes_no_branches_policy():
    with pytest.raises(ValueError):
        TLMNet(**TINY, rc_remat="branches")


@pytest.mark.parametrize(
    "weight,C", [((1.0, 4.0), 2), (None, 3), ((0.5, 1.0, 2.0), 3)]
)
def test_dice_and_segmentation_loss_match_jax(weight, C):
    """float32, rtol 1e-6."""
    from lmnet_tpu.losses import dice_loss, segmentation_loss

    rng = np.random.RandomState(4)
    logits = rng.randn(2, 8, 9, C).astype(np.float32) * 3
    labels = rng.randint(0, C, (2, 8, 9))
    jl, jy = jnp.asarray(logits), jnp.asarray(labels)
    tl, ty = torch.from_numpy(logits), torch.from_numpy(labels)
    np.testing.assert_allclose(float(t_dice(tl, ty, weight)), float(dice_loss(jl, jy, weight)),
                               rtol=1e-6)
    np.testing.assert_allclose(float(t_seg(tl, ty, weight, weight, 0.01)),
                               float(segmentation_loss(jl, jy, weight, weight, 0.01)), rtol=1e-6)


def test_cosine_epoch_schedule_matches_jax():
    """Per-epoch steps of the cosine, clamped after the last epoch; rtol
    1e-6 (JAX evaluates it in float32)."""
    from lmnet_tpu.train.engine import cosine_epoch_schedule as j_sched

    js, ts = j_sched(1e-3, 10, 4), cosine_epoch_schedule(1e-3, 10, 4)
    steps = np.arange(0, 48)
    np.testing.assert_allclose([ts(int(s)) for s in steps],
                               np.asarray(jax.vmap(js)(jnp.asarray(steps))), rtol=1e-6)
    assert ts(0) == ts(3) == 1e-3 and ts(4) < ts(3)


def _block_grads(jax_block, variables, port_block, x, r, train_args, port_kw):
    """Output, new stats and gradients (params and input) of one block,
    JAX against the port, for the scalar sum(out * r)."""
    xj = jnp.asarray(x)
    has_stats = "batch_stats" in variables

    def f(params, xx):
        v = {"params": params}
        if has_stats:
            v["batch_stats"] = variables["batch_stats"]
            out, mut = jax_block.apply(v, xx, *train_args, mutable=["batch_stats"])
        else:
            out, mut = jax_block.apply(v, xx, *train_args), {}
        return jnp.sum(out * jnp.asarray(r)), (out, mut)

    (_, (j_out, j_mut)), (j_gp, j_gx) = jax.jit(
        jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(variables["params"], xj)
    xt = torch.from_numpy(x).requires_grad_()
    out = port_block(xt, **port_kw)
    (out * torch.from_numpy(r)).sum().backward()
    return jax.device_get((j_out, j_mut, j_gp, j_gx)), out.detach(), xt.grad


def test_reparam_conv_train_mode_matches_jax():
    """One ReparamConv in train mode, checkpointed (remat) on the port's
    side: output, the five BN running statistics, every parameter gradient
    and the input gradient; float32, rtol 1e-4 / atol 1e-5 x max (outputs,
    stats) and as ``_close_grads`` (gradients)."""
    from lmnet_tpu.models.blocks import ReparamConv

    rng = np.random.RandomState(8)
    x = rng.randn(2, 12, 10, 4).astype(np.float32)
    r = rng.randn(2, 12, 10, 6).astype(np.float32)
    jb = ReparamConv(8, 6, 5, 3)
    variables = _filled(jb, x.shape, 7, True)
    sd = {}
    convert._put_rc(sd, "b", variables["params"], variables["batch_stats"])
    tb = t_blocks.ReparamConv(4, 8, 6, remat=True)
    tb.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    (j_out, j_mut, j_gp, j_gx), out, gx = _block_grads(jb, variables, tb, x, r, (True,), {"train": True})
    _close(out.numpy(), j_out, 1e-4, 1e-5, "out")
    _close(gx.numpy(), j_gx, 1e-3, 1e-4, "dx")
    want_stats, want_grads = {}, {}
    convert._put_rc(want_stats, "b", variables["params"], j_mut["batch_stats"])
    convert._put_rc(want_grads, "b", j_gp, None)
    got = tb.state_dict()
    for k, v in want_stats.items():
        if "running" in k:
            _close(got[k[2:]].numpy(), v.numpy(), 1e-4, 1e-5, k)
    _close_grads({k: p.grad.numpy() for k, p in tb.named_parameters()},
                 {k: v.numpy() for k, v in want_grads.items()}, lambda k: k[2:])


def test_neighborhood_transformer_train_mode_matches_jax(no_dropout):
    """One NeighborhoodTransformer (patch embed, LN, NAT with its rpb, MLP)
    in train mode with dropout off: output, every parameter gradient and
    the input gradient; float32, rtol 1e-4 / atol 1e-5 x max (output) and
    as ``_close_grads`` (gradients)."""
    from lmnet_tpu.models.blocks import NeighborhoodTransformer

    rng = np.random.RandomState(9)
    x = rng.randn(2, 9, 7, 8).astype(np.float32)
    r = rng.randn(2, 9, 7, 8).astype(np.float32)
    jb = NeighborhoodTransformer(8, HEADS, nat_backend="xla")
    variables = _filled(jb, x.shape, 7, True)
    sd = {}
    convert._put_natt(sd, "b", variables["params"])
    tb = t_blocks.NeighborhoodTransformer(8, HEADS)
    tb.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    gen = torch.Generator().manual_seed(0)
    (j_out, _, j_gp, j_gx), out, gx = _block_grads(
        jb, variables, tb, x, r, (True,), {"deterministic": False, "generator": gen})
    _close(out.numpy(), j_out, 1e-4, 1e-5, "out")
    _close(gx.numpy(), j_gx, 1e-3, 1e-4, "dx")
    want = {}
    convert._put_natt(want, "b", j_gp)
    _close_grads({k: p.grad.numpy() for k, p in tb.named_parameters()},
                 {k: v.numpy() for k, v in want.items()}, lambda k: k[2:])


def test_dropout_is_seeded_inverted_and_needs_a_generator():
    x = torch.ones(4, 64, 64)
    a = t_blocks.dropout(x, 0.1, torch.Generator().manual_seed(3))
    b = t_blocks.dropout(x, 0.1, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    kept = a != 0
    assert 0.08 < 1 - kept.float().mean().item() < 0.12
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 0.9))
    with pytest.raises(ValueError):
        t_blocks.dropout(x, 0.1, None)
    # train mode draws masks, eval mode does not
    m = t_blocks.Mlp(8, 16)
    with torch.no_grad():
        m.fc1.init_(torch.Generator().manual_seed(0))
        m.fc2.init_(torch.Generator().manual_seed(1))
    h = torch.randn(2, 5, 8)
    assert torch.equal(m(h), m(h))
    assert not torch.equal(m(h), m(h, False, torch.Generator().manual_seed(0)))


def test_bf16_policy_keeps_parameters_and_statistics_float32():
    """``LMNet(dtype=bfloat16)``: bf16 activations, float32 logits,
    parameters, gradients and BN running statistics stay float32."""
    m = TLMNet(**TINY, dtype=torch.bfloat16)
    seen = []
    m.natt4.att1.register_forward_hook(lambda mod, i, o: seen.append(o.dtype))
    state = create_train_state(m, (B, HW, HW, 3), device="cpu")
    x, y = _batches(1, seed=5)[0]
    state, loss, _ = train_step(state, torch.from_numpy(x), torch.from_numpy(y).long(),
                                ConfusionAccumulator.init(2))
    assert seen == [torch.bfloat16] and loss.dtype == torch.float32
    assert np.isfinite(float(loss))
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in m.parameters())
    assert all(b.dtype == torch.float32 for b in m.buffers())
    with torch.no_grad():
        assert m(torch.from_numpy(x)).dtype == torch.float32


def test_train_one_epoch_and_evaluate_run_the_port_loop():
    """The loop at TINY on synthetic batches: one step per batch, finite
    loss, JAX's metric keys plus images_per_sec; evaluate gives the CE
    total and the metrics."""
    from lmnet_tpu_torch.data import SyntheticDataset, make_loader

    model = TLMNet(**TINY, generator=torch.Generator().manual_seed(1))
    state = create_train_state(model, (B, HW, HW, 3), device="cpu", epochs=2, steps_per_epoch=2)
    state, total, metrics = train_one_epoch(
        state, make_loader(SyntheticDataset(4, HW, "val", seed=0), B), img_size=HW,
        augment_on_device=False)
    assert state.step == 2 and np.isfinite(total)
    keys = {"accuracy", "precision", "recall", "specificity", "dice", "iou", "mean_iou"}
    assert set(metrics) == keys | {"images_per_sec"} and metrics["images_per_sec"] > 0
    loss, m = evaluate(state, make_loader(SyntheticDataset(4, HW, "val", seed=1), B), img_size=HW)
    assert np.isfinite(loss) and set(m) == keys


def test_entry_points_default_to_the_card():
    """``create_train_state`` and ``serving_evaluate`` run on 'cuda' unless
    the caller asks for the CPU (JAX runs both on its default backend, the
    accelerator); without a card the default raises, as torch does."""
    import inspect

    from lmnet_tpu_torch.serve import serving_evaluate

    for fn in (create_train_state, serving_evaluate):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__


def test_unported_loop_options_raise():
    """The train augmentation and HD95, once unported, now run (over an
    empty loader: no steps, HD95 nan); a batch shape the model cannot take
    still raises."""
    state = create_train_state(TLMNet(**TINY), (B, HW, HW, 3), device="cpu")
    state, total, _ = train_one_epoch(state, iter(()), augment_on_device=True)
    assert state.step == 0 and total == 0.0
    _, m = evaluate(state, iter(()), compute_hd95=True)
    assert np.isnan(m["hd95"])
    with pytest.raises(ValueError):
        create_train_state(TLMNet(**TINY), (B, 30, 30, 3), device="cpu")
