"""The train-mode BatchNorm of the port (``ops/bn_train.py``,
``csrc/bn_train.cu``).

On the CPU: ``BatchNorm.train_forward`` takes the plain version (the float32
composition it always ran, bitwise), the closed-form backward the kernels
compute against autograd of that composition, the global count, and the
wrapper's checks.

On a CUDA card (marker ``gpu``; skipped without one): the kernels against the
plain version at C = 12 ... 192 and a ragged row count in bf16 and float32,
their gradients against autograd of the plain version, both again at a row
count where every thread of the statistics kernels walks four periods at a
time, two calls bitwise equal, two gloo ranks of a global batch against one
process on the concatenated batch, the running statistics updated once under
``torch.utils.checkpoint``, and the launches of a TINY train step. Those tests
import no JAX: on the card they run with
``python -m pytest --noconftest -m gpu tests/test_torch_bn_train.py``.
"""

import math
import os
import socket
import subprocess
import sys

import pytest
import torch

from lmnet_tpu_torch.models.blocks import BN_EPS, BatchNorm, ReparamConv
from lmnet_tpu_torch.ops import _build
from lmnet_tpu_torch.ops.bn_train import (
    BLOCKS_PER_SM,
    MAX_C,
    PERIOD_VECTORS,
    _check,
    batch_norm_train,
    batch_norm_train_backward,
    batch_norm_train_plain,
)
from lmnet_tpu_torch.parallel import batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHANNELS = (12, 24, 48, 96, 192)
# (B, H, W): N = 105 rows (odd: C = 12's 24-element periods end mid-period)
# and N = 4,092 (every thread walks whole periods, four at a time)
SHAPES = ((3, 7, 5), (4, 33, 31))
TINY = dict(num_classes=2, filters=(4, 8, 12, 16, 24), num_heads=2)


def _bn(C: int, seed: int = 0) -> BatchNorm:
    g = torch.Generator().manual_seed(seed)
    bn = BatchNorm(C)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.uniform_(-0.5, 0.5, generator=g)
    return bn


def _x(shape, C, seed=1, dtype=torch.float32):
    """Inputs with a channel-dependent offset and scale, as a conv's output."""
    g = torch.Generator().manual_seed(seed)
    off = torch.linspace(-2.0, 3.0, C)
    scale = torch.linspace(0.2, 4.0, C)
    return (torch.randn(*shape, C, generator=g) * scale + off).to(dtype)


# -- CPU ------------------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", (12, 48))
def test_train_forward_takes_the_plain_version_on_cpu(dtype, C):
    """On a CPU tensor ``train_forward`` is the float32 composition it was
    before the kernels (moments of x.float(), then the normalisation of
    ``normalize``), bitwise, and launches nothing."""
    bn, x = _bn(C), _x((2, 5, 7), C, dtype=dtype)
    launches = batch_norm_train.launches
    y, mean, var = bn.train_forward(x)
    want_mean, want_var = batch.moments(x.float(), (0, 1, 2))
    assert torch.equal(mean, want_mean) and torch.equal(var, want_var)
    assert torch.equal(y, bn.normalize(x, want_mean, want_var))
    assert y.dtype == dtype
    assert batch_norm_train.launches == launches


@pytest.mark.parametrize("C", CHANNELS)
def test_closed_form_backward_matches_autograd_of_the_plain_version(C):
    """The backward the kernels compute, dx = gamma rstd (dy - sum dy / n -
    xhat sum(dy xhat) / n), dgamma = sum dy xhat, dbeta = sum dy, against
    autograd of the plain version's arithmetic, both in float64: 1e-10 of
    each gradient's largest entry (float64 rounding)."""
    bn = _bn(C).double()
    x = _x((3, 7, 5), C).double().requires_grad_()
    dy = _x((3, 7, 5), C, seed=2).double()
    xf = x.detach().reshape(-1, C)
    n = xf.shape[0]
    mean = xf.mean(0)
    rstd = torch.rsqrt((xf.square().mean(0) - mean.square()).clamp(min=0) + BN_EPS)
    xhat = (xf - mean) * rstd
    d = dy.reshape(-1, C)
    db, dw = d.sum(0), (d * xhat).sum(0)
    dx = bn.weight.detach() * rstd * (d - db / n - xhat * dw / n)
    m = x.mean((0, 1, 2))
    v = torch.clamp(x.square().mean((0, 1, 2)) - m.square(), min=0.0)
    y = (x - m) * (torch.rsqrt(v + BN_EPS) * bn.weight) + bn.bias
    gx, gw, gb = torch.autograd.grad((y * dy).sum(), (x, bn.weight, bn.bias))
    for got, want in ((dx, gx.reshape(-1, C)), (dw, gw), (db, gb)):
        assert (got - want).abs().max() <= 1e-10 * want.abs().max()


def test_stat_count_is_the_count_moments_divides_by():
    """Outside a global batch the count of the dims; inside an H shard with
    no global batch it raises, as ``moments`` does."""
    x = torch.zeros(3, 4, 5, 6)
    assert batch.stat_count(x, (0, 1, 2)) == 60
    assert batch.sum_group() is None
    with batch.shard(None, 0, 2):
        with pytest.raises(RuntimeError):
            batch.stat_count(x, (0, 1, 2))
        with pytest.raises(RuntimeError):
            batch.moments(x, (0, 1, 2))


@pytest.mark.parametrize("shape,C", [((2, 3, 12), 12), ((2, 3, 4, MAX_C + 1), MAX_C + 1),
                                     ((0, 3, 4, 8), 8), ((2, 3, 4, 257), 257),
                                     ((2, 3, 4, 514), 514)])
def test_the_wrapper_refuses_what_the_kernels_do_not_take(shape, C):
    """Not NHWC, too wide, empty, or more than 256 float32 vectors a period
    of lcm(4, C) elements (C = 257, 514)."""
    with pytest.raises(ValueError):
        _check(torch.zeros(shape), torch.zeros(C))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", (*CHANNELS, 256, 264, 1024))
def test_the_wrapper_takes_every_width_of_the_model_and_wider_aligned_ones(dtype, C):
    """Every C up to 256, and wider ones that the vector width divides."""
    _check(torch.zeros(1, 1, 2, C, dtype=dtype), torch.zeros(C))


def test_the_wrapper_refuses_a_weight_of_another_width():
    with pytest.raises(ValueError):
        _check(torch.zeros(2, 3, 4, 8), torch.zeros(7))
    with pytest.raises(ValueError):
        _check(torch.zeros(2, 3, 4, 8, dtype=torch.float16), torch.zeros(8))


# -- the card -------------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("C", CHANNELS)
def test_kernels_match_the_plain_version(cuda, dtype, shape, C):
    """y, mean and var against the plain version on the same input. mean
    and var are float32 sums taken in another order: mean within 1e-5 of
    sqrt(E[x^2]), var within 1e-5 of E[x^2] (E[x^2] - E[x]^2 cancels to
    there). y: float32 within 1e-4 (1e-5 relative statistics times
    |xhat| <= ~4, times gamma <= 1.5); bf16 within 2**-7 |y| + 1e-3 (one
    rounding of the stored result, a bf16 ulp apart at most)."""
    bn = _bn(C).to(cuda)
    x = _x(shape, C, dtype=dtype).to(cuda)
    launches = batch_norm_train.launches
    y, mean, var = batch_norm_train(x, bn.weight, bn.bias, BN_EPS)
    torch.cuda.synchronize()
    assert batch_norm_train.launches == launches + 1
    assert y.dtype == dtype and y.shape == x.shape
    wy, wmean, wvar = batch_norm_train_plain(x, bn.weight, bn.bias, BN_EPS)
    ms = x.float().square().mean((0, 1, 2))
    assert bool(((mean - wmean).abs() <= 1e-5 * ms.sqrt()).all())
    assert bool(((var - wvar).abs() <= 1e-5 * ms).all())
    err = (y.float() - wy.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-4
    else:
        assert bool((err <= 2**-7 * wy.float().abs() + 1e-3).all()), err.max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("C", CHANNELS)
def test_gradients_match_autograd_of_the_plain_version(cuda, shape, C):
    """dx, dgamma, dbeta in float32 against autograd of the plain version:
    each within 1e-4 of its largest entry (float32 sums in another order,
    and the closed form against autograd's chain through mean and var)."""
    bn = _bn(C).to(cuda)
    x = _x(shape, C).to(cuda)
    dy = _x(shape, C, seed=2).to(cuda)
    got, want = [], []
    for fn, out in ((batch_norm_train, got), (batch_norm_train_plain, want)):
        bn.zero_grad()
        xr = x.clone().requires_grad_()
        y, _, _ = fn(xr, bn.weight, bn.bias, BN_EPS)
        (y * dy).sum().backward()
        out += [xr.grad, bn.weight.grad.clone(), bn.bias.grad.clone()]
    for name, g, w in zip(("dx", "dgamma", "dbeta"), got, want):
        err = (g - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item(), (name, err)


@pytest.mark.gpu
@pytest.mark.parametrize("C", (12, 24, 192))
def test_two_calls_are_bitwise_equal(cuda, C):
    """bf16 at 16 x 64^2 rows: the statistics, y, dx, dgamma and dbeta of two
    calls, bitwise."""
    bn = _bn(C).to(cuda)
    x = _x((16, 64, 64), C, dtype=torch.bfloat16).to(cuda)
    dy = _x((16, 64, 64), C, seed=2, dtype=torch.bfloat16).to(cuda)
    runs = []
    for _ in range(2):
        bn.zero_grad()
        xr = x.clone().requires_grad_()
        y, mean, var = batch_norm_train(xr, bn.weight, bn.bias, BN_EPS)
        y.backward(dy)
        runs.append((y, mean, var, xr.grad, bn.weight.grad.clone(), bn.bias.grad.clone()))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def _rows_for_four_deep_walks(C: int, dtype) -> int:
    """Rows enough that every thread of the persistent statistics kernels
    walks its periods four at a time (``csrc/bn_train.cu::stream``'s main
    loop) at least once, then more: five grids' worth of block tiles, each
    tile ``PERIOD_VECTORS // ct`` periods of ``r0`` rows (the kernels'
    geometry), plus 3 rows of a partial period."""
    vw = 16 // torch.tensor([], dtype=dtype).element_size()
    d = math.gcd(vw, C)
    tile_rows = PERIOD_VECTORS // (C // d) * (vw // d)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 5 * BLOCKS_PER_SM * sms * tile_rows + 3


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", CHANNELS)
def test_kernels_match_the_plain_version_where_threads_walk_four_periods_at_a_time(cuda, dtype,
                                                                                  C):
    """At a row count where the statistics kernels' grid is full and each
    thread loads four vectors before it uses any (the train cell's regime),
    y, mean, var, dx, dgamma and dbeta against the plain version and its
    autograd on the same values in float32, by the tolerances of the two
    tests above: mean and var within 1e-5 of sqrt(E[x^2]) and E[x^2]; in
    float32 y within 1e-4 and dx within 1e-4 of its largest entry; in bf16 y
    and dx within 2**-7 |ref| + 1e-3 (a bf16 ulp); dgamma and dbeta within
    1e-4 of the largest entry (float32 sums in another order). The bf16
    reference is the float32 one: autograd of the bf16 composition rounds
    its two partial gradients of x (gamma rstd dy, and the part through
    mean and var) to bf16 before it adds them, and where dy's channel mean
    is large against its spread (here up to 10x) they cancel: its dx lies up
    to 0.066 from its own float32 value, 58x this rule's tolerance (CPU,
    10^5 rows); the kernels round once."""
    rows = _rows_for_four_deep_walks(C, dtype)
    bn = _bn(C).to(cuda)
    x = _x((1, rows, 1), C, dtype=dtype).to(cuda)
    dy = _x((1, rows, 1), C, seed=2, dtype=dtype).to(cuda)
    got, want = [], []
    for fn, xi, dyi, out in ((batch_norm_train, x, dy, got),
                             (batch_norm_train_plain, x.float(), dy.float(), want)):
        bn.zero_grad()
        xr = xi.clone().requires_grad_()
        y, mean, var = fn(xr, bn.weight, bn.bias, BN_EPS)
        y.backward(dyi)
        out += [y.detach(), mean, var, xr.grad, bn.weight.grad.clone(), bn.bias.grad.clone()]
    ms = x.float().square().mean((0, 1, 2))
    assert bool(((got[1] - want[1]).abs() <= 1e-5 * ms.sqrt()).all())
    assert bool(((got[2] - want[2]).abs() <= 1e-5 * ms).all())
    for name, g, w in (("y", got[0], want[0]), ("dx", got[3], want[3])):
        err = (g.float() - w.float()).abs()
        if dtype == torch.float32:
            tol = 1e-4 * (1.0 if name == "y" else w.abs().max().item())
            assert err.max().item() <= tol, (name, err.max().item())
        else:
            assert bool((err <= 2**-7 * w.float().abs() + 1e-3).all()), (name, err.max().item())
    for name, g, w in (("dgamma", got[4], want[4]), ("dbeta", got[5], want[5])):
        err = (g - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item(), (name, err)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, port: int, path: str) -> None:
    """One of two gloo ranks: its half of the saved batch inside a global
    batch of both, forward and backward through the kernels."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    d = torch.load(path)
    dev = torch.device("cuda")
    half = d["x"].shape[0] // 2
    rows = slice(rank * half, (rank + 1) * half)
    bn = BatchNorm(d["w"].shape[0]).to(dev)
    with torch.no_grad():
        bn.weight.copy_(d["w"])
        bn.bias.copy_(d["b"])
    x = d["x"][rows].to(dev).requires_grad_()
    with batch.global_batch(dist.group.WORLD, d["x"].shape[0], rows.start):
        y, mean, var = bn.train_forward(x)
        y.backward(d["dy"][rows].to(dev))
    torch.cuda.synchronize()
    torch.save({"y": y.cpu(), "mean": mean.cpu(), "var": var.cpu(), "dx": x.grad.cpu(),
                "dw": bn.weight.grad.cpu(), "db": bn.bias.grad.cpu(),
                "counts": dict(batch.COUNTS),
                "launches": (batch_norm_train.launches, batch_norm_train_backward.launches)},
               f"{path}.rank{rank}")
    dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shift", [(torch.bfloat16, 0.0), (torch.float32, 20.0)])
@pytest.mark.parametrize("C", (12, 96))
def test_two_gloo_ranks_match_one_process_on_the_concatenated_batch(cuda, C, dtype, shift,
                                                                     tmp_path):
    """Two ranks, each with half of a batch, inside one global batch: one
    all-reduce each way a rank; every rank's mean and var equal. bf16 against
    one process on the whole batch: mean and var within 1e-5 of sqrt(E[x^2])
    and E[x^2]; y and dx, row for row, within 2**-7 |ref| + 1e-3 (a bf16
    ulp); the ranks' dgamma and dbeta summed within 1e-4 of the largest entry
    (float32 sums in another order). float32 with every channel shifted by
    20, so that E[x^2] is up to ~10^4 var and E[x^2] - E[x]^2 cancels: mean
    and var within 1e-6 relative (the float64 sums rounded to float32 once
    more), y, dx, dgamma and dbeta within 1e-5 of their largest entry."""
    _build.build("bn_train")  # once, before the ranks
    bn = _bn(C)
    x = (_x((4, 24, 20), C) + shift).to(dtype)
    dy = _x((4, 24, 20), C, seed=2, dtype=dtype)
    path = str(tmp_path / "batch.pt")
    torch.save({"x": x, "dy": dy, "w": bn.weight.detach(), "b": bn.bias.detach()}, path)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests")]))
    procs = [subprocess.Popen([sys.executable, "-c",
                               f"import test_torch_bn_train as t; t._rank_main({r}, {port}, "
                               f"{path!r})"], env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            assert p.returncode == 0, out[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    ranks = [torch.load(f"{path}.rank{r}") for r in range(2)]

    bn = bn.to(cuda)
    xr = x.to(cuda).requires_grad_()
    y, mean, var = bn.train_forward(xr)
    y.backward(dy.to(cuda))
    for r in ranks:
        assert r["counts"] == {"forward": 1, "backward": 1, "grads": 0, "halo": 0}
        assert r["launches"] == (1, 1)
        assert torch.equal(r["mean"], ranks[0]["mean"]) and torch.equal(r["var"], ranks[0]["var"])
    refs = {"y": y, "dx": xr.grad, "dw": bn.weight.grad, "db": bn.bias.grad}
    got = {"y": torch.cat([r["y"] for r in ranks]), "dx": torch.cat([r["dx"] for r in ranks]),
           "dw": ranks[0]["dw"] + ranks[1]["dw"], "db": ranks[0]["db"] + ranks[1]["db"]}
    if dtype == torch.float32:
        for key, ref in (("mean", mean), ("var", var)):
            torch.testing.assert_close(ranks[0][key], ref.cpu(), rtol=1e-6, atol=0.0)
        for key, ref in refs.items():
            err = (got[key] - ref.cpu()).abs().max().item()
            assert err <= 1e-5 * ref.abs().max().item(), (key, err)
        return
    ms = x.float().square().mean((0, 1, 2))
    assert bool(((ranks[0]["mean"] - mean.cpu()).abs() <= 1e-5 * ms.sqrt()).all())
    assert bool(((ranks[0]["var"] - var.cpu()).abs() <= 1e-5 * ms).all())
    for key in ("y", "dx"):
        g, ref = got[key].float(), refs[key].float().cpu()
        assert bool(((g - ref).abs() <= 2**-7 * ref.abs() + 1e-3).all()), key
    for key in ("dw", "db"):
        err = (got[key] - refs[key].cpu()).abs().max().item()
        assert err <= 1e-4 * refs[key].abs().max().item(), (key, err)


@pytest.mark.gpu
@pytest.mark.parametrize("remat", (True, "branches"))
def test_running_statistics_are_updated_once_under_checkpoint(cuda, remat):
    """A ReparamConv block's five BatchNorms under ``torch.utils.checkpoint``
    (the recompute runs the kernels again) move their running statistics
    as the same block without a checkpoint does: once (float32; within
    1e-6 of the largest, where a second update would move them by ~10 %)."""
    blocks = {}
    for r in (False, remat):
        torch.manual_seed(0)
        blk = ReparamConv(8, 24, 8, remat=r)
        with torch.no_grad():
            for m in blk.modules():
                if hasattr(m, "init_"):
                    m.init_(torch.Generator().manual_seed(3))
        blocks[r] = blk.to(cuda)
    x = _x((2, 16, 16), 8).to(cuda)
    launches = (batch_norm_train.launches, batch_norm_train_backward.launches)
    for blk in blocks.values():
        xr = x.clone().requires_grad_()
        blk(xr, train=True).square().sum().backward()
    torch.cuda.synchronize()
    # 5 forwards and 5 backwards a block, and the checkpoint's 5 recomputed forwards
    assert (batch_norm_train.launches - launches[0],
            batch_norm_train_backward.launches - launches[1]) == (15, 10)
    plain, ckpt = (dict(b.named_buffers()) for b in blocks.values())
    for k, ref in plain.items():
        init = torch.zeros_like(ref) if k.endswith("running_mean") else torch.ones_like(ref)
        assert not torch.equal(ref, init), k
        assert (ckpt[k] - ref).abs().max() <= 1e-6 * ref.abs().max(), k


@pytest.mark.gpu
@pytest.mark.parametrize("backend,forwards,backwards", [("xla", 84 + 80, 84),
                                                        ("packed", 84 + 80, 84),
                                                        ("fused", 20 + 16, 20)])
def test_launches_of_a_tiny_train_step(cuda, backend, forwards, backwards):
    """A TINY bf16 ``train_step`` with ``rc_remat=True``: every train-mode
    BatchNorm runs the kernels. 'xla' and 'packed': the 84 of the forward
    (16 blocks x 5, 4 skips), the 80 of the blocks again in the recompute,
    and the 84 backwards; 'fused': the 16 expand BatchNorms and 4 skips (the
    branch statistics are B6's), the 16 recomputed, and 20 backwards."""
    from lmnet_tpu_torch.metrics import ConfusionAccumulator
    from lmnet_tpu_torch.models import LMNet
    from lmnet_tpu_torch.train import create_train_state, train_step

    model = LMNet(**TINY, generator=torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                  rc_remat=True, rc_train_backend=backend)
    state = create_train_state(model, (2, 32, 32, 3), seed=0, device=cuda)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 32, 32, 3, generator=g).to(cuda)
    y = (x.mean(-1) > 0).long()
    before = (batch_norm_train.launches, batch_norm_train_backward.launches)
    _, loss, _ = train_step(state, x, y, ConfusionAccumulator.init(2, cuda))
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert (batch_norm_train.launches - before[0],
            batch_norm_train_backward.launches - before[1]) == (forwards, backwards)
