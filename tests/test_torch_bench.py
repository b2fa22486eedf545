"""``bench_torch.py``, the port's counterpart of ``bench.py``, on the CPU.

The protocol's constants and JSON keys are read from ``bench.py`` with
``ast`` (importing it would start JAX's benchmark setup). The serving chain
runs at TINY, 32^2, B=2, 2 iterations, float32, on weights converted from
JAX variables, against the same chain over JAX's ``deploy_forward``; the
training chain against a hand loop of ``train_step``.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bench_torch
from conftest import TINY
from lmnet_tpu_torch.convert import jax_to_state_dict
from lmnet_tpu_torch.metrics import ConfusionAccumulator
from lmnet_tpu_torch.models import LMNet as TLMNet
from lmnet_tpu_torch.models import structural_reparam as t_structural_reparam
from lmnet_tpu_torch.train import cosine_epoch_schedule, create_train_state, train_step
from test_torch_serve import jax_variables

BENCH = Path(__file__).resolve().parents[1] / "bench.py"
HW, B, ITERS = 32, 2, 2


def _bench_tree() -> ast.Module:
    return ast.parse(BENCH.read_text())


def _calls(tree, name: str) -> list:
    return [n for n in ast.walk(tree) if isinstance(n, ast.Call)
            and isinstance(n.func, ast.Name) and n.func.id == name]


def test_protocol_constants_equal_bench_py():
    """A100_EST_IMG_S, BATCH, TRAIN_BATCH, ITERS and REPS as bench.py sets
    them; the larger sizes, their batch and reps (``serve_rate(384, 128)``,
    ``range(2)``); the training input's size and its schedule's epochs and
    steps."""
    tree = _bench_tree()
    consts = {t.id: ast.literal_eval(n.value) for n in tree.body if isinstance(n, ast.Assign)
              for t in n.targets if isinstance(t, ast.Name)}
    for name in ("A100_EST_IMG_S", "BATCH", "TRAIN_BATCH", "ITERS", "REPS"):
        assert getattr(bench_torch, name) == consts[name], name
    large = [tuple(ast.literal_eval(a) for a in c.args) for c in _calls(tree, "serve_rate")]
    assert large == [(s, bench_torch.BATCH) for s in bench_torch.LARGE_SIZES]
    serve_fn = next(n for n in ast.walk(tree)
                    if isinstance(n, ast.FunctionDef) and n.name == "serve_rate")
    assert [ast.literal_eval(c.args[0]) for c in _calls(serve_fn, "range")] == [
        bench_torch.LARGE_REPS]
    main_fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    inputs = {n.targets[0].id: n.value for n in ast.walk(main_fn) if isinstance(n, ast.Assign)
              and isinstance(n.targets[0], ast.Name) and n.targets[0].id in ("x", "xt", "yt")}
    assert {ast.literal_eval(e) for v in inputs.values() for e in v.args[0].elts[1:3]} == {
        bench_torch.SIZE}
    (cts,) = _calls(tree, "create_train_state")
    kw = {k.arg: ast.literal_eval(k.value) for k in cts.keywords}
    state = bench_torch.training_state("cpu")
    want = cosine_epoch_schedule(1e-3, kw["epochs"], kw["steps_per_epoch"])
    assert [state.schedule(s) for s in (0, 99, 100, 7000, 20000)] == [
        want(s) for s in (0, 99, 100, 7000, 20000)]
    assert state.model.dtype == torch.bfloat16 and state.model.conv1[0].remat is True


def test_summary_keys_are_bench_py_keys_and_device():
    """The last line's keys: bench.py's seven (the dict it prints) and
    ``device``; ``value`` and ``vs_baseline`` as bench.py rounds them."""
    tree = _bench_tree()
    (dumps,) = [c for c in ast.walk(tree) if isinstance(c, ast.Call)
                and isinstance(c.func, ast.Attribute) and c.func.attr == "dumps"]
    keys = [ast.literal_eval(k) for k in dumps.args[0].keys]
    rates = {"serve_256": 2000.04, "train_256": 210.06, "serve_384": 900.0, "serve_512": 480.0}
    out = bench_torch.summary({k: {"img_s": v} for k, v in rates.items()}, "card, 700.00 W")
    assert list(out) == keys + ["device"]
    assert out["value"] == 2000.0 and out["vs_baseline"] == round(2000.04 / 1500.0, 3)
    assert (out["train_img_s"], out["img_s_384"], out["img_s_512"]) == (210.1, 900.0, 480.0)
    assert "card" in out["metric"] and "chip" not in out["metric"]
    assert out["unit"] == "img/s" and out["device"] == "card, 700.00 W"


def test_serve_chain_matches_jax_chain():
    """serve_rate's accumulator (the last chain's sum of the logits of 2
    calls) on ones at TINY 32^2, B=2, float32, against the same fori_loop
    chain over JAX's deploy_forward(nat_backend='xla') on the same weights.
    Tolerance: the serving tests' rtol 1e-4 / atol 1e-5 on every logit,
    summed: 1e-4 x the summed |logits| + 1e-5 x the number of logits."""
    from lmnet_tpu.models import structural_reparam
    from lmnet_tpu.serve.engine import deploy_forward

    variables = jax_variables()
    model = TLMNet(**TINY)
    model.load_state_dict(jax_to_state_dict(variables), strict=True)
    deploy = t_structural_reparam(model.eval().state_dict())
    got = bench_torch.serve_rate(deploy, HW, B, ITERS, 1, "cpu", dtype=torch.float32)

    jd = jax.device_get(structural_reparam(variables))
    heads = TINY["num_heads"]
    x = jnp.ones((B, HW, HW, 3), jnp.float32)

    def chain(x):
        def body(i, acc):
            y = deploy_forward(jd, x + acc.astype(x.dtype) * 1e-20, num_heads=heads,
                               nat_backend="xla")
            return acc + jnp.sum(y)

        return jax.lax.fori_loop(0, ITERS, body, jnp.zeros(()))

    want = float(jax.jit(chain)(x))
    logits = np.asarray(deploy_forward(jd, x, num_heads=heads, nat_backend="xla"))
    tol = ITERS * (1e-4 * np.abs(logits).sum() + 1e-5 * logits.size)
    assert np.isfinite(got["acc"]) and abs(got["acc"] - want) <= tol, (got["acc"], want, tol)
    assert got["reps"] == 1 and got["img_s"] > 0 and got["peak_gib"] is None
    assert got["launches"] == {"nat_fwd": 0, "nat_bwd": 0}  # CPU tensors: the plain NAT


def _tiny_state():
    model = TLMNet(**TINY, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(3))
    return create_train_state(model, (1, 64, 64, 3), seed=3, device="cpu", epochs=200,
                              steps_per_epoch=100)


def test_train_chain_equals_hand_loop():
    """train_rate's warm-up chain and one timed chain of 2 steps each equal
    4 train_steps by hand from the same seed, bitwise on the CPU: the last
    chain's summed losses, every parameter, the step count and the dropout
    generator. The hand loop feeds the ones themselves: ``acc * 1e-20``
    rounds away in float32."""
    a = _tiny_state()
    got = bench_torch.train_rate(a, HW, B, ITERS, 1, "cpu")

    b = _tiny_state()
    x = torch.ones((B, HW, HW, 3))
    y = torch.zeros((B, HW, HW), dtype=torch.int32)
    cm0 = ConfusionAccumulator.init(2, "cpu")
    losses = [train_step(b, x, y, cm0)[1] for _ in range(2 * ITERS)]
    acc = torch.zeros(())
    for loss in losses[ITERS:]:
        acc = acc + loss
    assert got["acc"] == float(acc)
    assert a.step == b.step == 2 * ITERS
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_main_raises_without_a_card(monkeypatch):
    """No fallback: without a card, main() raises before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_torch.main()
