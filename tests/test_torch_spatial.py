"""The mesh's 'spatial' axis in the port: the image H sharded over gloo ranks
on the CPU (``lmnet_tpu_torch/parallel/spatial.py``, the shard in
``parallel/batch.py``, ``parallel/mesh.py``, the model's blocks, the loops,
the serving engine and the CLI), at TINY.

Six ranks run ``tests/_torch_spatial_worker.py`` (torch and the port only,
one thread each): two on a (1 x 2) mesh and four on a (2 x 2) mesh. They
start first; while they run, this process compiles JAX's whole-model
gradient on the same global batch and runs the port in one process. Every
check holds the ranks' blocks against the whole map in one process:

* each primitive (float32): output and every gradient within 1e-6 x the
  largest value, elementwise, of the whole-map computation;
* the TINY train step (dropout off) against JAX's step on the global batch
  (JAX's spatial mesh computes the same function, as ``dryrun_multichip``
  asserts) and against the port's one process: PERF.md's training rule
  (loss rtol 1e-5, every gradient as ``tests/test_torch_train.py::
  _close_grads``, running statistics rtol 1e-4 / atol 1e-5 x max), which
  also holds the gradient's scale (the mean over all n_data x n_spatial
  ranks, not n_spatial x it); the ranks end bitwise equal;
* the same step with rc_train_backend='fused' and the 'flat' upsample
  (B6, B5 and B7 on each rank's slab; their plain windowed versions on the
  CPU) by the same rules;
* deploy_forward with rc_backend 'flat' (B5) and 'pallas' (B4) and the
  'flat' upsample (B7) on the blocks against JAX's deploy_forward on the
  whole map, fp32 rtol 1e-4 / atol 1e-5 (the serving row of PERF.md);
* evaluate and serving_evaluate as ``tests/test_torch_parallel.py``, the CLI
  rows within 5e-4 (also with --rc_train_backend fused and the flat
  upsample); the deploy options and 'packed' on a shard; the fallback at
  an H the axis does not shard;

and, in this process, the rule that picks the blocks.
"""

import csv
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import TINY
from test_torch_parallel import _free_port, _global_batch, _port_model
from test_torch_train import _close, _close_grads, _filled

from lmnet_tpu_torch import convert
from lmnet_tpu_torch.cli import train as cli
from lmnet_tpu_torch.data import SyntheticDataset, make_loader
from lmnet_tpu_torch.metrics import ConfusionAccumulator
from lmnet_tpu_torch.models import LMNet as TLMNet
from lmnet_tpu_torch.models import blocks as t_blocks
from lmnet_tpu_torch.ops import resize
from lmnet_tpu_torch.ops.nat import neighborhood_attention
from lmnet_tpu_torch.parallel import batch as pbatch
from lmnet_tpu_torch.parallel import mesh as pmesh
from lmnet_tpu_torch.serve import deploy_forward, serving_evaluate
from lmnet_tpu_torch.train import create_train_state, evaluate, train_one_epoch, train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_spatial_worker.py")
HW, B, SEED = 32, 3, 3  # JAX's and the port's global batch of tests/test_torch_parallel.py
FALLBACK_HW = 48  # 48 % (16 x 2) != 0: the axis runs whole images
MESHES = {"1x2": 2, "2x2": 4}  # mesh -> ranks
CLI_ARGS = [
    "--synthetic", "--k_fold", "False", "--batch_size", "2", "--img_size", str(HW),
    "--filters", "4,8,12,16,24", "--num_heads", "2", "--seed", "42", "--device", "cpu",
    "--num_workers", "1",
]
CONVS = {  # name -> (kh, kw, stride, groups)
    "conv3x3": (3, 3, 1, 1), "conv5x5_dw": (5, 5, 1, 4), "conv3x1": (3, 1, 1, 1),
    "conv1x3": (1, 3, 1, 1), "conv3x3_s2": (3, 3, 2, 1),
}
PRIMS = [*CONVS, "up", "pool", "se", "gft", "nat_h4", "nat_h8"]


def _cli_argv(root):
    return CLI_ARGS + ["--ckpt_dir", str(root / "ckpt"), "--out_dir", str(root / "out")]


def _prim_inputs():
    """The whole maps every primitive runs on, from a numpy seed."""
    rng = np.random.RandomState(21)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))

    convs = {}
    for name, (kh, kw, stride, groups) in CONVS.items():
        x = t(2, 16, 8, 4)
        cout = 4 if groups > 1 else 6
        convs[name] = dict(x=x, w=t(cout, 4 // groups, kh, kw, scale=0.3), b=t(cout, scale=0.1),
                           g=t(2, 16 // stride, 8 // stride, cout), stride=stride, groups=groups)
    torch.manual_seed(0)
    se, gft = t_blocks.SE(8), t_blocks.GFT(8, 6, 2)
    for m in (se, gft):
        for p in m.parameters():
            p.data = t(*p.shape, scale=0.3)
    nat = {f"nat_h{h}": dict(x=t(2, h, w, 12), rpb=t(2, 5, 5, scale=0.3), g=t(2, h, w, 4))
           for h, w in ((4, 5), (8, 6))}
    return dict(
        convs=convs,
        up=dict(x=t(2, 8, 6, 4), g=t(2, 16, 12, 4)),
        pool=dict(xs=[t(2, 16, 8, 3), t(2, 8, 4, 3), t(2, 4, 2, 3), t(2, 2, 1, 3)],
                  g=t(2, 2, 1, 12)),
        se=dict(x=t(2, 8, 4, 8), sd=se.state_dict(), g=t(2, 8, 4, 8)),
        gft=dict(x=t(2, 4, 4, 8), sd=gft.state_dict(), g=t(2, 4, 4, 6), cout=6, heads=2),
        nat=nat,
        dropout=dict(like=torch.zeros(2, 8, 4, 6), seed=5),
    )


@pytest.fixture(scope="module")
def variables():
    from lmnet_tpu.models import LMNet

    return _filled(LMNet(**TINY), (1, HW, HW, 3), 0)


@pytest.fixture(scope="module")
def launched(variables, tmp_path_factory):
    """The six ranks, started: {mesh: (directory, processes)}."""
    root = tmp_path_factory.mktemp("spatial")
    torch.save(convert.jax_to_state_dict(variables), root / "sd.pt")
    x, y = _global_batch()
    torch.save({"x": torch.from_numpy(x), "y": torch.from_numpy(y).long()}, root / "batch.pt")
    torch.save(_prim_inputs(), root / "prims.pt")
    runs = {}
    for mesh, world in MESHES.items():
        d = root / mesh
        d.mkdir()
        cases = (["prims", "step", "fused", "serve_rc", "eval", "options", "fallback", "cli",
                  "cli_fused"] if world == 2 else ["step", "fused", "serve_rc"])
        spec = dict(tiny=TINY, hw=HW, fallback_hw=FALLBACK_HW, seed=SEED, n_spatial=2,
                    state_dict=str(root / "sd.pt"), batch=str(root / "batch.pt"),
                    prims=str(root / "prims.pt"), dir=str(d), cli_argv=_cli_argv(d),
                    cli_fused_argv=_cli_argv(d / "fused"), cases=cases)
        (d / "spec.json").write_text(json.dumps(spec))
        port = _free_port()
        procs = []
        for rank in range(world):
            env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
            procs.append(subprocess.Popen([sys.executable, WORKER, str(d / "spec.json")], env=env,
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True))
        runs[mesh] = (d, procs)
    yield runs
    for _, procs in runs.values():
        for p in procs:
            if p.poll() is None:
                p.kill()


@pytest.fixture(scope="module")
def jax_step(variables, launched):
    """JAX's train-mode loss, running statistics and gradients on the global
    batch (the TINY model, 'xla' NAT, dropout off), compiled while the
    ranks run."""
    from lmnet_tpu.losses import segmentation_loss
    from lmnet_tpu.models import LMNet

    model = LMNet(**TINY, nat_backend="xla", rc_remat=False)

    def loss_fn(params, batch_stats, x, y):
        logits, mut = model.apply({"params": params, "batch_stats": batch_stats}, x, train=True,
                                  deterministic=True, mutable=["batch_stats"])
        return segmentation_loss(logits, y), mut["batch_stats"]

    x, y = _global_batch()
    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"], jnp.asarray(x), jnp.asarray(y))
    loss, stats, grads = jax.device_get((loss, stats, grads))
    sd = convert.jax_to_state_dict({"params": variables["params"], "batch_stats": stats})
    return (float(loss), {k: v.numpy() for k, v in sd.items() if "running" in k},
            {k: v.numpy() for k, v in convert.jax_to_state_dict({"params": grads}).items()})


@pytest.fixture(scope="module")
def jax_logits(variables, launched):
    """JAX's float32 deploy_forward ('xla' ReparamConv and NAT) on the whole
    global batch, computed while the ranks run."""
    from lmnet_tpu.models import structural_reparam
    from lmnet_tpu.serve import deploy_forward

    deploy = jax.device_get(structural_reparam(variables))
    return np.asarray(deploy_forward(deploy, jnp.asarray(_global_batch()[0]),
                                     num_heads=TINY["num_heads"], nat_backend="xla",
                                     rc_backend="xla"))


@pytest.fixture(scope="module")
def ranks(launched):
    """Every rank's results, once they have ended: {mesh: [rank0, ...]}."""
    out = {}
    for mesh, (d, procs) in launched.items():
        for p in procs:
            said, _ = p.communicate(timeout=300)
            assert p.returncode == 0, said[-4000:]
        out[mesh] = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(len(procs))]
    return out


def _grad_run(fn, inputs, g_out, params=()):
    leaves = [t.clone().requires_grad_() for t in inputs]
    y = fn(*leaves)
    (y * g_out).sum().backward()
    return y.detach(), [t.grad for t in leaves], [p.grad.clone() for p in params]


def _whole(name, data):
    """(output, input gradients, parameter gradients) of primitive ``name``
    on the whole maps, in one process."""
    if name in CONVS:
        c = data["convs"][name]
        return _grad_run(lambda x, w, b: t_blocks.conv_nhwc(x, w, b, c["stride"], c["groups"]),
                         [c["x"], c["w"], c["b"]], c["g"])
    if name == "up":
        return _grad_run(lambda x: resize.bilinear_resize(x, (2 * x.shape[1], 2 * x.shape[2])),
                         [data["up"]["x"]], data["up"]["g"])
    if name == "pool":
        p = data["pool"]
        return _grad_run(lambda *xs: t_blocks.pyramid_pool(xs[:-1], xs[-1]), p["xs"], p["g"])
    if name in ("se", "gft"):
        s = data[name]
        torch.manual_seed(0)
        m = t_blocks.SE(8) if name == "se" else t_blocks.GFT(8, s["cout"], s["heads"])
        m.load_state_dict(s["sd"])
        return _grad_run(m, [s["x"]], s["g"], list(m.parameters()))
    n = data["nat"][name]
    rpb = n["rpb"].clone().requires_grad_()
    C = n["x"].shape[-1] // 3
    y, gx, _ = _grad_run(lambda x: neighborhood_attention(x[..., :C], x[..., C:2 * C],
                                                          x[..., 2 * C:], rpb, 3),
                         [n["x"]], n["g"])
    return y, gx, [rpb.grad]


def _near(got, want, name):
    """Elementwise within 1e-6 x max|want| (float32 sums in another order)."""
    _close(got.numpy(), want.numpy(), 1e-6, 1e-6, name)


@pytest.mark.parametrize("name", PRIMS)
def test_primitive_on_two_blocks_matches_the_whole_map(ranks, name, launched):
    """Each primitive on the (1 x 2) mesh's two blocks of rows against the
    whole map: the output and the maps' gradients (the blocks joined in
    rank order), the weights' gradients (summed over the ranks). NAT's
    input gradient holds dq, dk and dv in its channel thirds, and its
    second output d_rpb; at H = 4 every query row is a global edge or a
    block edge."""
    d, _ = launched["1x2"]
    data = torch.load(d.parent / "prims.pt", weights_only=True)
    want_y, want_gx, want_gp = _whole(name, data)
    got = [r["prims"][name] for r in ranks["1x2"]]
    _near(torch.cat([g[0] for g in got], dim=1), want_y, f"{name} output")
    maps = 4 if name == "pool" else 1  # the inputs that are maps; a conv's weights follow
    for i, w in enumerate(want_gx):
        parts = [g[1][i] for g in got]
        _near(torch.cat(parts, dim=1) if i < maps else sum(parts), w, f"{name} input gradient {i}")
    gp = [sum(ps) for ps in zip(*(g[2] for g in got))]
    for i, w in enumerate(want_gp):
        _near(gp[i], w, f"{name} parameter gradient {i}")


def test_dropout_masks_are_cut_from_the_global_mask(ranks):
    """A rank's mask is its block of the mask one process draws from the
    same generator."""
    want = t_blocks.dropout_keep((2, 8, 4, 6), 0.5, torch.Generator().manual_seed(5), "cpu")
    got = torch.cat([r["prims"]["dropout"] for r in ranks["1x2"]], dim=1)
    assert torch.equal(got, want)


def _step_matches(variables, jax_step, got, monkeypatch, **model_kw):
    """The ranks' step results ``got`` against JAX's step on the global batch
    and the port's one-process step with ``model_kw``: the loss, every
    gradient, the running statistics, the confusion matrix; the ranks end
    bitwise equal."""
    j_loss, j_stats, j_grads = jax_step
    np.testing.assert_allclose(float(got[0]["loss"]), j_loss, rtol=1e-5)
    _close_grads({k: g.numpy() for k, g in got[0]["grads"].items()}, j_grads)
    for k, want in j_stats.items():
        _close(got[0]["state"][k].numpy(), want, 1e-4, 1e-5, k)
    for g in got[1:]:
        assert torch.equal(g["loss"], got[0]["loss"]) and torch.equal(g["cm"], got[0]["cm"])
        for k, v in got[0]["state"].items():
            assert torch.equal(v, g["state"][k]), k

    monkeypatch.setattr(t_blocks, "DROPOUT", 0.0)
    x, y = _global_batch()
    state = create_train_state(_port_model(variables, **model_kw), (B, HW, HW, 3),
                               device="cpu")
    state, loss, cm = train_step(state, torch.from_numpy(x), torch.from_numpy(y).long(),
                                 ConfusionAccumulator.init(2))
    np.testing.assert_allclose(float(got[0]["loss"]), float(loss), rtol=1e-5)
    assert torch.equal(got[0]["cm"], cm)
    _close_grads({k: g.numpy() for k, g in got[0]["grads"].items()},
                 {n: p.grad.numpy() for n, p in state.model.named_parameters()})


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tiny_step_matches_jax_and_one_process(variables, jax_step, ranks, mesh, monkeypatch):
    """One train_step of TINY at 32^2 with H over the 'spatial' axis (blocks
    of 16 rows) against JAX's step on the global batch and the port's one
    process: the loss, every gradient (their scale included: the world's
    mean), the running statistics, the confusion matrix; the ranks end
    bitwise equal."""
    _step_matches(variables, jax_step, [r["step"] for r in ranks[mesh]], monkeypatch)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tiny_fused_flat_step_matches_jax_and_one_process(variables, jax_step, ranks, mesh,
                                                          monkeypatch):
    """The step with rc_train_backend='fused' and the 'flat' upsample on the
    blocks (B6's statistics and B5's SE sums over each rank's slab, then
    over the world; B7 in global coordinates; the fused backward on the
    slab, its halo rows' gradients sent home) against JAX's step on the
    global batch and the port's one-process 'fused' + 'flat' step, by the
    same rules."""
    monkeypatch.setattr(resize, "UPSAMPLE_BACKEND", "flat")
    _step_matches(variables, jax_step, [r["fused"] for r in ranks[mesh]], monkeypatch,
                  rc_train_backend="fused")


def test_collectives_a_fused_sharded_step(ranks):
    """The 'fused' + 'flat' step issues the same collectives on every rank of
    both meshes, and on CPU tensors (where 'fused' is the plain branch
    graph on the slab and B7 its plain windowed lerp) the 'xla' step's: one
    exchange of 2 rows a ReparamConv block, one row each side an upsample,
    the same BatchNorm and SE sums."""
    counts = [r["fused"]["collectives"] for m in MESHES for r in ranks[m]]
    assert all(c == counts[0] for c in counts), counts
    assert counts[0] == ranks["1x2"][0]["step"]["collectives"]


def _joined(ranks, mesh, key):
    """Each data rank's blocks of the ranks' ``serve_rc[key]`` joined in
    rank order (rank = data x 2 + spatial): one whole batch a data rank."""
    got = [r["serve_rc"][key] for r in ranks[mesh]]
    return [torch.cat(got[d:d + 2], dim=1) for d in range(0, len(got), 2)]


@pytest.mark.parametrize("rc", ["flat", "pallas"])
def test_one_process_serving_rc_backends_match_jax(variables, jax_logits, rc):
    """The port's one-process deploy_forward with rc_backend 'flat' (B5's
    plain version) or 'pallas' (B4's), float32, against JAX's
    deploy_forward on the whole map: rtol 1e-4, atol 1e-5 (PERF.md's
    serving row). The sharded runs are held to this one below."""
    from lmnet_tpu_torch.models import structural_reparam

    deploy = structural_reparam(_port_model(variables).state_dict())
    with torch.no_grad():
        got = deploy_forward(deploy, torch.from_numpy(_global_batch()[0]), TINY["num_heads"],
                             "plain", rc)
    np.testing.assert_allclose(got.numpy(), jax_logits, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("up", ["einsum", "flat"])
@pytest.mark.parametrize("rc", ["flat", "pallas"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_serving_rc_backends_on_blocks_match_one_process(variables, ranks, mesh, rc, up,
                                                         monkeypatch):
    """deploy_forward with rc_backend 'flat' (B5: the halo of e, its sums
    all-reduced) or 'pallas' (B4: the slab of x with no rows past the
    global edges, phase 1's sums all-reduced between the phases), with the
    'einsum' or the 'flat' upsample (B7 on each rank's slab, global
    coordinates), float32, each rank's block of the global batch; the
    blocks joined (on (2 x 2) every data rank serves the same blocks)
    against the port's one-process deploy_forward with the same backends:
    the same function, float32 sums in another order, elementwise within
    1e-5 |ref| + 1e-5 max|ref|, as the deploy options on a shard.

    Against JAX's logits directly (rtol 1e-4, atol 1e-5) the sharded
    'flat' and 'pallas' come to 1.02x that bound at one logit of 6,144
    (error 1.49e-5 against a largest logit of 12.06): the shard moves
    every backend's logits by up to ~9e-6 from one process's (the 'xla'
    ReparamConv too, which then sits at 0.64x), and the one-process 'flat'
    already sits at 0.92x."""
    from lmnet_tpu_torch.models import structural_reparam

    monkeypatch.setattr(resize, "UPSAMPLE_BACKEND", up)
    deploy = structural_reparam(_port_model(variables).state_dict())
    with torch.no_grad():
        want = deploy_forward(deploy, torch.from_numpy(_global_batch()[0]), TINY["num_heads"],
                              "plain", rc)
    for joined in _joined(ranks, mesh, (rc, up)):
        _close(joined.numpy(), want.numpy(), 1e-5, 1e-5, f"{rc} + {up} upsample")


def test_collectives_a_sharded_step(ranks):
    """A sharded TINY step (rc_remat, 'xla' ReparamConv) issues, on every
    rank of both meshes: 53 halo exchanges in the forward (16 ReparamConv
    blocks' one each, 4 downsamples, 17 in the skips, 2 in each NATT block,
    2 in each up stage), their 53 backwards and the 16 recomputed blocks'
    16; 101 all-reduces in the forward (84 BNs, 16 SE means, the GFT's
    gather), their 101 backwards, 96 in the recompute (80 BNs, 16 SE), 2
    for the loss; 1 of the gradients."""
    want = {"forward": 101 + 96 + 2, "backward": 101 + 2, "grads": 1, "halo": 53 + 53 + 16}
    for mesh in MESHES:
        for r in ranks[mesh]:
            assert r["step"]["collectives"] == want, (mesh, r["step"]["collectives"])


def test_evaluate_and_serving_on_two_blocks_match_one_process(variables, ranks):
    """evaluate (float32) and serving_evaluate (bf16, rc_backend 'auto',
    which draws from 'xla' and 'flat', on a shard too) with HD95 on the gathered
    maps, on (1 x 2), against one process: eval loss rtol 1e-5 and metrics
    to 1e-12, HD95 within 1e-9; served by PERF.md's bf16 serving rule."""
    state = create_train_state(_port_model(variables), (2, HW, HW, 3), device="cpu")
    val = SyntheticDataset(5, HW, "val", seed=SEED + 1)
    el, em = evaluate(state, make_loader(val, 2, num_threads=1), img_size=HW, compute_hd95=True)
    sl, sm = serving_evaluate(state.model.state_dict(), make_loader(val, 2, num_threads=1), 2,
                              HW, num_heads=TINY["num_heads"], device="cpu", compute_hd95=True)
    got = [r["eval"] for r in ranks["1x2"]]
    np.testing.assert_equal(got[0], got[1])
    (gl, gm), (gsl, gsm) = got[0]["evaluate"], got[0]["serve"]
    np.testing.assert_allclose(gl, el, rtol=1e-5)
    for k, v in em.items():
        np.testing.assert_allclose(gm[k], v, rtol=0, atol=1e-9 if k == "hd95" else 1e-12,
                                   err_msg=k)
    np.testing.assert_allclose(gsl, sl, rtol=2e-2)
    for k, v in sm.items():
        np.testing.assert_allclose(gsm[k], v, err_msg=k,
                                   atol={"accuracy": 2.5e-2, "hd95": 1.0}.get(k, 2e-2))


@pytest.mark.parametrize("option", ["natt_int8", "ln_fold", "skip_compose", "packed"])
def test_options_run_on_two_blocks(variables, ranks, option):
    """The deploy options and rc_train_backend='packed' run on a shard and
    give the whole map's float32 logits (the blocks joined): within 1e-5 x
    max|ref|; natt_int8 within 0.05 x max|ref| (its static int8 steps may
    round a value the other way)."""
    from lmnet_tpu_torch.models import structural_reparam

    x = torch.from_numpy(_global_batch()[0])
    model = _port_model(variables, rc_train_backend="packed")
    with torch.no_grad():
        if option == "packed":
            want = model(x, train=True, deterministic=True)
        else:
            want = deploy_forward(structural_reparam(model.state_dict()), x, TINY["num_heads"],
                                  "plain", **{option: True})
    got = torch.cat([r["options"][option] for r in ranks["1x2"]], dim=1)
    tol = 5e-2 if option == "natt_int8" else 1e-5
    _close(got.numpy(), want.numpy(), tol, tol, option)


def test_fallback_where_h_does_not_divide(variables, ranks):
    """At 48^2 (48 % 32 != 0) both ranks of the axis run whole images (JAX's
    fallback replicates H): the epoch and evaluate give one process's
    numbers (train loss rtol 1e-5, metrics to 1e-12; the parameters within
    1e-2, as tests/test_torch_parallel.py says why)."""
    got = [r["fallback"] for r in ranks["1x2"]]
    np.testing.assert_equal((got[0]["train"], got[0]["eval"]), (got[1]["train"], got[1]["eval"]))
    state = create_train_state(_port_model(variables), (2, FALLBACK_HW, FALLBACK_HW, 3),
                               seed=SEED, device="cpu", epochs=1, steps_per_epoch=2)
    train = SyntheticDataset(4, FALLBACK_HW, "train", seed=SEED)
    state, tl, tm = train_one_epoch(state, make_loader(train, 2, shuffle=True, seed=SEED,
                                                       num_threads=1),
                                    img_size=FALLBACK_HW, seed=SEED)
    tm.pop("images_per_sec")
    np.testing.assert_allclose(got[0]["train"][0], tl, rtol=1e-5)
    for k, v in tm.items():
        np.testing.assert_allclose(got[0]["train"][1][k], v, rtol=0, atol=1e-12, err_msg=k)
    for k, v in state.model.state_dict().items():
        np.testing.assert_allclose(got[0]["state"][k].numpy(), v.numpy(), atol=1e-2, err_msg=k)
    same = create_train_state(TLMNet(**TINY), (2, FALLBACK_HW, FALLBACK_HW, 3), device="cpu")
    same.model.load_state_dict(got[0]["state"])
    vl, vm = evaluate(same, make_loader(SyntheticDataset(3, FALLBACK_HW, "val", seed=1), 2,
                                        num_threads=1), img_size=FALLBACK_HW)
    np.testing.assert_allclose(got[0]["eval"][0], vl, rtol=1e-5)
    for k, v in vm.items():
        np.testing.assert_allclose(got[0]["eval"][1][k], v, rtol=0, atol=1e-12, err_msg=k)


def test_cli_n_spatial_matches_one_process(ranks, launched, tmp_path):
    """``--distributed True --n_spatial 2 --device cpu`` on 2 ranks (2
    epochs, then --test --hd95 and --test --serve) writes the CSV rows one
    process writes, within 5e-4 (4 decimals; the served row by the bf16
    serving rule's 0.02), rank 0 alone."""
    d, _ = launched["1x2"]
    cli.main(_cli_argv(tmp_path) + ["--epochs", "2"])
    cli.main(_cli_argv(tmp_path) + ["--epochs", "2", "--test", "--hd95"])
    cli.main(_cli_argv(tmp_path) + ["--epochs", "2", "--test", "--serve"])
    _cli_rows_match(d, tmp_path)


def _cli_rows_match(d, tmp_path):
    """The CSV rows the ranks wrote under ``d`` against one process's under
    ``tmp_path``: within 5e-4, the served row within 2e-2."""
    def rows(p):
        with open(p, encoding="utf-8") as f:
            return [np.array(r, dtype=np.float64) for r in csv.reader(f) if r]

    for name in ("LM_NetKvasir_0.csv", "LM_NetKvasirbestresult_0.csv"):
        got, want = rows(d / "out" / name), rows(tmp_path / "out" / name)
        assert len(got) == len(want) == (1 if "bestresult" in name else 2), name
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=5e-4, err_msg=name)
    (g_test, g_serve), (w_test, w_serve) = (rows(p / "out" / "LM_NetKvasirtest_rvd_class.csv")
                                            for p in (d, tmp_path))
    np.testing.assert_allclose(g_test, w_test, rtol=0, atol=5e-4)
    np.testing.assert_allclose(g_serve, w_serve, rtol=0, atol=2e-2)


def test_cli_n_spatial_fused_flat_matches_one_process(ranks, launched, tmp_path, monkeypatch):
    """The same CLI cycle with ``--rc_train_backend fused`` and the 'flat'
    upsample (B6, B5 and B7 on each rank's slabs) writes the rows one
    process writes with the same flags, by the same rules."""
    d, _ = launched["1x2"]
    assert ranks["1x2"][0]["cli_fused"]
    monkeypatch.setattr(resize, "UPSAMPLE_BACKEND", "flat")
    argv = _cli_argv(tmp_path) + ["--epochs", "2", "--rc_train_backend", "fused"]
    cli.main(argv)
    cli.main(argv + ["--test", "--hd95"])
    cli.main(argv + ["--test", "--serve"])
    _cli_rows_match(d / "fused", tmp_path)


class _Mesh:
    """A mesh's shape and this rank's place, as ``DeviceMesh`` gives them."""

    def __init__(self, n_data, n_spatial, d=0, s=0):
        self.shape, self.place = (n_data, n_spatial), (d, s)

    def size(self, dim):
        return self.shape[dim]

    def get_local_rank(self, dim):
        return self.place[("data", "spatial").index(dim)]


@pytest.mark.parametrize("H,n,sharded", [(32, 2, True), (48, 2, False), (512, 2, True),
                                         (256, 4, True), (96, 4, False), (64, 1, False)])
def test_shards_h_and_the_blocks(H, n, sharded):
    """H is sharded where it divides by 16 x the axis; the blocks tile H in
    rank order; shard_batch cuts rows, then the block, or keeps H whole."""
    assert pmesh.shards_h(_Mesh(1, n), H) is sharded
    assert not pmesh.shards_h(_Mesh(1, n), H, spatial=False)
    got = np.concatenate([np.arange(H)[pmesh.h_rows(_Mesh(1, n, 0, s), H)] for s in range(n)])
    np.testing.assert_array_equal(got, np.arange(H))


def test_shard_batch_cuts_rows_and_h(monkeypatch):
    monkeypatch.setattr(pmesh, "shard_rows", lambda mesh, n: slice(1, 3))
    x = np.arange(3 * 32 * 2 * 3, dtype=np.float32).reshape(3, 32, 2, 3)
    mesh = _Mesh(2, 2, 1, 1)
    mesh.device_type = "cpu"
    xs, ys = pmesh.shard_batch(mesh, x, x[..., 0])
    np.testing.assert_array_equal(xs.numpy(), x[1:3, 16:])
    np.testing.assert_array_equal(ys.numpy(), x[1:3, 16:, :, 0])
    xs, _ = pmesh.shard_batch(mesh, x, x[..., 0], spatial=False)
    np.testing.assert_array_equal(xs.numpy(), x[1:3])


def test_batch_statistics_on_a_shard_need_a_global_batch():
    """A block's own BatchNorm statistics are not the map's: inside a shard
    without a global batch, moments raises instead of computing them."""
    with pbatch.shard(None, 0, 2), pytest.raises(RuntimeError, match="global_batch"):
        t_blocks.BatchNorm(3)(torch.randn(2, 4, 4, 3), train=True)


def test_the_primitives_outside_a_shard_are_the_plain_code():
    """Outside a shard halo, crop, gather_rows and own_rows give x back,
    spatial_mean is x.mean, and ``whole`` changes nothing."""
    from lmnet_tpu_torch.parallel import spatial

    x = torch.randn(2, 4, 3, 5)
    assert spatial.halo(x, 2, 2) is x and spatial.crop(x, 1, 1, edges=False) is x
    assert spatial.gather_rows(x) is x and spatial.own_rows(x) is x
    assert torch.equal(spatial.spatial_mean(x), x.mean(dim=(1, 2), keepdim=True))
    with pbatch.whole():
        assert pbatch.current_shard() is None
    with pbatch.shard(None, 1, 2):
        with pbatch.whole():
            assert pbatch.current_shard() is None
            assert spatial.halo(x, 1, 1) is x
        assert pbatch.current_shard().index == 1
