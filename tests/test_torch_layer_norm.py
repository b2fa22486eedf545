"""The port's LayerNorm (``ops/layer_norm.py``, ``csrc/layer_norm.cu``).

On the CPU: ``blocks.LayerNorm`` takes the plain version, which is bitwise
the float32 composition the module ran before the kernels, forward and
gradients; the closed-form backward the kernels compute against autograd of
that composition (the clamp of the variance included); and the width check.

On a CUDA card (marker ``gpu``; skipped without one): the kernels against
the plain version at the port's nine widths (SegFormer's 64, 128, 320, 512;
LM-Net's NATT 12, 24, 48, 96 and GFT 372) in bf16 and float32, row counts
that do not fill the last warp's rows, widths off the 8- and 16-byte
vectors and rows wider than a warp (LM-Net's GFT at doubled filters, 744,
up to the widest, 4096), two calls bitwise equal, the launch counters, what
autograd saves, capture and replay in a CUDA graph, and the refusal of
widths the kernels do not take. Those tests import no
JAX: on the card they run with
``python -m pytest --noconftest -m gpu tests/test_torch_layer_norm.py``.
"""

import pytest
import torch

from lmnet_tpu_torch.models.blocks import LN_EPS, LayerNorm
from lmnet_tpu_torch.ops.layer_norm import (
    MAX_C,
    check,
    layer_norm,
    layer_norm_backward,
    layer_norm_plain,
)

WIDTHS = (12, 24, 48, 96, 372, 64, 128, 320, 512)
# single-element loads (not a multiple of 4, or of 2 in bf16), a row over
# two warps (744: the GFT's at --filters 24,48,96,192,384), over 4 and over
# the whole block (4096, MAX_C)
OTHER_WIDTHS = (1, 10, 30, 744, 1026, 2052, 4095, MAX_C)
DTYPES = (torch.float32, torch.bfloat16)
# (B, H, W): 105 rows (fills no warp's rows at any packing) and 4,092
SHAPES = ((3, 7, 5), (4, 33, 31))
TINY = dict(num_classes=2, filters=(4, 8, 12, 16, 24), num_heads=2)


def _ln(C: int, seed: int = 0, eps: float = LN_EPS) -> LayerNorm:
    g = torch.Generator().manual_seed(seed)
    ln = LayerNorm(C, eps)
    with torch.no_grad():
        ln.weight.uniform_(0.5, 1.5, generator=g)
        ln.bias.uniform_(-0.5, 0.5, generator=g)
    return ln


def _x(shape, C, seed=1, dtype=torch.float32):
    """Rows with their own offset and scale, as a residual stream's."""
    g = torch.Generator().manual_seed(seed)
    n = torch.Size(shape).numel()
    off = torch.linspace(-3.0, 3.0, n).reshape(*shape, 1)
    scale = torch.linspace(0.5, 4.0, n).flip(0).reshape(*shape, 1)
    return (torch.randn(*shape, C, generator=g) * scale + off).to(dtype)


def _former(x, weight, bias, eps, stats_dtype=torch.float32):
    """``blocks.LayerNorm.forward`` as it was before the kernels; its
    statistics in ``stats_dtype``."""
    xf = x.to(stats_dtype)
    mean = xf.mean(dim=-1)
    var = torch.clamp(xf.square().mean(dim=-1) - mean.square(), min=0.0)
    y = (x - mean[..., None]) * (torch.rsqrt(var + eps)[..., None] * weight)
    return (y + bias).to(x.dtype)


def _fwd_bwd(fn, x, dy, w, b, eps=LN_EPS):
    """(y, dx, dweight, dbias) of ``fn(x, w, b, eps)`` and its autograd
    backward from ``dy``."""
    xr, wr, br = (t.detach().clone().requires_grad_() for t in (x, w, b))
    y = fn(xr, wr, br, eps)
    y.backward(dy)
    return y, xr.grad, wr.grad, br.grad


# -- CPU ------------------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C", WIDTHS)
def test_plain_version_is_the_former_composition_bitwise(dtype, C):
    """y, dx, dweight and dbias of ``layer_norm_plain`` equal those of the
    module's former float32 composition bitwise, at the port's widths."""
    ln, x = _ln(C), _x((2, 3, 5), C, dtype=dtype)
    dy = _x((2, 3, 5), C, seed=2, dtype=dtype)
    got = _fwd_bwd(layer_norm_plain, x, dy, ln.weight, ln.bias)
    want = _fwd_bwd(_former, x, dy, ln.weight, ln.bias)
    assert got[0].dtype == dtype
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C", (12, 64, 372))
def test_module_takes_the_plain_version_on_cpu(dtype, C):
    """``LayerNorm`` on a CPU tensor is ``layer_norm_plain``, bitwise, with
    both epsilons SegFormer uses, and launches nothing."""
    x = _x((2, 4, 3), C, dtype=dtype)
    launches = (layer_norm.launches, layer_norm_backward.launches)
    for eps in (1e-5, 1e-6):
        ln = _ln(C, eps=eps)
        xr = x.clone().requires_grad_()
        y = ln(xr)
        assert torch.equal(y, layer_norm_plain(x, ln.weight, ln.bias, eps))
        y.float().sum().backward()
    assert (layer_norm.launches, layer_norm_backward.launches) == launches


def _closed_form(x, dy, w, eps):
    """The kernels' arithmetic in x's dtype: mean, the clamped variance and
    rstd (its sign marking the clamp), then dx = rstd (g - mean(g) - xhat
    mean(g xhat)) with g = dy w, the last term dropped where the clamp
    held; dweight = sum dy xhat, dbias = sum dy over the rows."""
    C = x.shape[-1]
    mean = x.mean(-1, keepdim=True)
    raw = x.square().mean(-1, keepdim=True) - mean.square()
    clamped = raw < 0
    rstd = torch.rsqrt(raw.clamp(min=0) + eps)
    xhat = (x - mean) * rstd
    g = dy * w
    mgx = torch.where(clamped, torch.zeros_like(raw), (g * xhat).sum(-1, keepdim=True) / C)
    dx = rstd * (g - g.sum(-1, keepdim=True) / C - xhat * mgx)
    rows = tuple(range(x.dim() - 1))
    return dx, (dy * xhat).sum(rows), dy.sum(rows)


@pytest.mark.parametrize("C", WIDTHS)
def test_closed_form_backward_matches_autograd_of_the_plain_version(C):
    """In float64 (the former composition with its statistics in float64),
    on rows of every spread and on constant rows (where E[x^2] - E[x]^2
    rounds to either side of 0, and the clamp may hold): each gradient
    within 1e-9 of its largest entry (float64 rounding; rstd reaches
    1/sqrt(eps) on the constant rows)."""
    ln = _ln(C).double()
    x = _x((3, 4, 5), C).double()
    x[0, 0] = 0.1
    x[1, 2] = -7.3
    x[2, 3] = 1e3 / 3
    dy = _x((3, 4, 5), C, seed=2).double()
    xr = x.clone().requires_grad_()
    y = _former(xr, ln.weight, ln.bias, LN_EPS, torch.float64)
    want = torch.autograd.grad((y * dy).sum(), (xr, ln.weight, ln.bias))
    got = _closed_form(x, dy, ln.weight.detach(), LN_EPS)
    for name, a, b in zip(("dx", "dweight", "dbias"), got, want):
        err = (a - b).abs().max().item()
        assert err <= 1e-9 * b.abs().max().item(), (name, err)


def test_closed_form_drops_the_variance_term_where_the_clamp_holds():
    """A row whose E[x^2] - E[x]^2 rounds below 0: autograd of the clamp
    passes no gradient through the variance, and neither does the closed
    form."""
    C = 12
    for v in (0.1, 0.3, 0.7, 1.1, 3.3, 1e3 / 3, -7.3):
        x = torch.full((1, C), v, dtype=torch.float64)
        if bool(x.square().mean() - x.mean().square() < 0):
            break
    else:
        pytest.fail("no constant row rounds its variance below 0")
    w = torch.linspace(0.5, 1.5, C, dtype=torch.float64)
    dy = torch.linspace(-1.0, 2.0, C, dtype=torch.float64)[None]
    xr = x.clone().requires_grad_()
    y = _former(xr, w, torch.zeros_like(w), LN_EPS, torch.float64)
    want = torch.autograd.grad((y * dy).sum(), xr)[0]
    got = _closed_form(x, dy, w, LN_EPS)[0]
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("C", (0, MAX_C + 1, MAX_C + 4, 2 * MAX_C, 3 * MAX_C - 1))
def test_the_check_refuses_widths_the_kernels_do_not_take(C):
    """Empty, or wider than the register budget: a clear error, with no
    card needed."""
    with pytest.raises(ValueError, match="last axis"):
        check(torch.zeros(2, 3, C, dtype=torch.bfloat16), torch.zeros(C))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C", (*WIDTHS, 4, 8, 36, 508))
def test_the_check_takes_every_width_of_the_port_and_other_multiples_of_4(dtype, C):
    check(torch.zeros(1, 2, C, dtype=dtype), torch.zeros(C))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C", (*OTHER_WIDTHS, 2))
def test_the_check_takes_widths_off_the_vectors_and_rows_past_a_warp(dtype, C):
    check(torch.zeros(1, 2, C, dtype=dtype), torch.zeros(C))


def test_the_check_takes_every_layer_norm_of_lm_net_at_doubled_filters():
    """``--filters 24,48,96,192,384``: the NATT blocks' 24 .. 192 and the
    GFT's 744."""
    from lmnet_tpu_torch.models import LMNet

    model = LMNet(filters=(24, 48, 96, 192, 384), num_heads=2)
    widths = sorted({m.weight.shape[0] for m in model.modules() if isinstance(m, LayerNorm)})
    assert 744 in widths
    for C in widths:
        check(torch.zeros(2, C, dtype=torch.bfloat16), torch.zeros(C))


@pytest.mark.parametrize("x,w", [
    (torch.zeros(2, 3, 8, dtype=torch.float16), torch.zeros(8)),
    (torch.zeros(2, 3, 8, dtype=torch.float64), torch.zeros(8)),
    (torch.zeros(0, 3, 8), torch.zeros(8)),
    (torch.zeros(2, 3, 8), torch.zeros(12)),
])
def test_the_check_refuses_other_dtypes_empty_tensors_and_weights_of_another_width(x, w):
    with pytest.raises(ValueError):
        check(x, w)


# -- the card -------------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _against_plain(x, dy, ln):
    """(name, kernels', plain version's, dtype) for y, dx, dweight and dbias
    on the same values. A bf16 x is held against the plain version on its
    float32 copy: the bf16 composition rounds its two partial gradients of
    x to bf16 before it adds them, a rounding of terms larger than dx, where
    the kernels round dx once."""
    got = _fwd_bwd(layer_norm, x, dy, ln.weight, ln.bias, ln.eps)
    want = _fwd_bwd(layer_norm_plain, x.float(), dy.float(), ln.weight, ln.bias, ln.eps)
    return [(n, a, b, x.dtype) for n, a, b in zip(("y", "dx", "dweight", "dbias"), got, want)]


def _close(name, got, want, dtype):
    """The kernels against the plain version in float32. y and dx: float32
    within 2e-5 of the tensor's largest entry (statistics summed in another
    order, E[x^2] - E[x]^2 cancelling to ~1e-6 of E[x^2] at these rows'
    offsets); bf16 within one rounding of the stored result, 2**-8 of the
    entry, plus 1e-4 of the largest. dweight and dbias: float32 sums of the
    same products over the rows in another order, within 1e-4 of the
    largest entry."""
    assert got.dtype == (torch.float32 if name in ("dweight", "dbias") else dtype)
    got, want = got.float(), want.float()
    err = (got - want).abs()
    top = want.abs().max().item()
    if name in ("dweight", "dbias"):
        bound = 1e-4 * top
    elif dtype == torch.float32:
        bound = 2e-5 * top
    else:
        bound = 2**-8 * want.abs() + 1e-4 * top
    assert bool((err <= bound).all()), (name, err.max().item(), top)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("C", (*WIDTHS, *OTHER_WIDTHS))
def test_kernels_match_the_plain_version(cuda, dtype, shape, C):
    """y, dx, dweight and dbias of the kernels against autograd of the plain
    version on the same values (``_against_plain``, ``_close``'s
    tolerances), at the port's widths and at ``OTHER_WIDTHS``."""
    ln = _ln(C).to(cuda)
    x, dy = _x(shape, C, dtype=dtype).to(cuda), _x(shape, C, seed=2, dtype=dtype).to(cuda)
    cases = _against_plain(x, dy, ln)
    torch.cuda.synchronize()
    assert cases[0][1].shape == x.shape
    for case in cases:
        _close(*case)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", (1, 3, 7, 9, 33, 257))
@pytest.mark.parametrize("C", (4, 12, 64, 96, 372, 512, 30, 744))
def test_row_counts_that_leave_a_warp_part_empty(cuda, rows, C):
    """Fewer rows than a warp or a block packs (8 a warp at C = 12, 4 at 64,
    2 at 96, 1 from 30 on; 256 a block at C = 4, 4 at 744), in bf16."""
    ln = _ln(C).to(cuda)
    x = _x((rows,), C, dtype=torch.bfloat16).to(cuda)
    dy = _x((rows,), C, seed=2, dtype=torch.bfloat16).to(cuda)
    for case in _against_plain(x, dy, ln):
        _close(*case)


@pytest.mark.gpu
@pytest.mark.parametrize("C", (12, 320, 372, 30, 744, MAX_C))
def test_two_calls_are_bitwise_equal(cuda, C):
    """bf16 at 8 x 64^2 rows: y, dx, dweight and dbias of two calls."""
    ln = _ln(C).to(cuda)
    x = _x((8, 64, 64), C, dtype=torch.bfloat16).to(cuda)
    dy = _x((8, 64, 64), C, seed=2, dtype=torch.bfloat16).to(cuda)
    a = _fwd_bwd(layer_norm, x, dy, ln.weight, ln.bias)
    b = _fwd_bwd(layer_norm, x, dy, ln.weight, ln.bias)
    assert all(torch.equal(p, q) for p, q in zip(a, b))


@pytest.mark.gpu
def test_launch_counters_and_what_autograd_saves(cuda):
    """One forward and one backward launch a call; the graph keeps x in its
    own dtype and two float32 row vectors, no float32 tensor of x's size;
    without a gradient for x the backward still gives dweight and dbias."""
    ln = _ln(320).to(cuda)
    x = _x((2, 16, 16), 320, dtype=torch.bfloat16).to(cuda).requires_grad_()
    before = (layer_norm.launches, layer_norm_backward.launches)
    y = ln(x)
    saved = y.grad_fn.saved_tensors
    assert sorted((str(t.dtype), t.numel()) for t in saved) == sorted(
        [("torch.bfloat16", x.numel()), ("torch.float32", 320), ("torch.float32", 512),
         ("torch.float32", 512)])
    y.float().sum().backward()
    assert (layer_norm.launches - before[0], layer_norm_backward.launches - before[1]) == (1, 1)
    ln.zero_grad()
    y = ln(x.detach())
    y.float().sum().backward()
    assert ln.weight.grad is not None and ln.bias.grad is not None
    assert (layer_norm.launches - before[0], layer_norm_backward.launches - before[1]) == (2, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("C", (64, 372, 744))
def test_capture_and_replay_in_a_cuda_graph(cuda, C):
    """Forward and backward captured in one CUDA graph, replayed on new
    inputs copied into the static ones: bitwise the eager call's results."""
    ln = _ln(C).to(cuda)
    x = torch.zeros(4, 32, 32, C, dtype=torch.bfloat16, device=cuda, requires_grad=True)
    dy = torch.zeros_like(x)
    params = (x, ln.weight, ln.bias)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        torch.autograd.grad(ln(x), params, dy)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = ln(x)
        grads = torch.autograd.grad(y, params, dy)
    new_x = _x((4, 32, 32), C, seed=3, dtype=torch.bfloat16).to(cuda)
    new_dy = _x((4, 32, 32), C, seed=4, dtype=torch.bfloat16).to(cuda)
    with torch.no_grad():
        x.copy_(new_x)
        dy.copy_(new_dy)
    graph.replay()
    want = _fwd_bwd(layer_norm, new_x, new_dy, ln.weight, ln.bias, ln.eps)
    torch.cuda.synchronize()
    assert torch.equal(y, want[0])
    assert all(torch.equal(a, b) for a, b in zip(grads, want[1:]))


@pytest.mark.gpu
@pytest.mark.parametrize("C", (MAX_C + 1, MAX_C + 4, 2 * MAX_C))
def test_the_card_raises_for_widths_the_kernels_do_not_take(cuda, C):
    """No other composition on the card: the module raises."""
    ln = LayerNorm(C).to(cuda)
    with pytest.raises(ValueError, match="last axis"):
        ln(torch.zeros(2, 3, C, device=cuda, dtype=torch.bfloat16))


@pytest.mark.gpu
def test_launches_of_a_tiny_train_step(cuda):
    """A bf16 train step of LM-Net at TINY widths (NATT 4, 8, 12, 16 and the
    GFT's 64): its 10 LayerNorms a forward, each once backward."""
    from lmnet_tpu_torch.metrics import ConfusionAccumulator
    from lmnet_tpu_torch.models import LMNet
    from lmnet_tpu_torch.train import create_train_state, train_step

    model = LMNet(generator=torch.Generator().manual_seed(0), dtype=torch.bfloat16, **TINY)
    state = create_train_state(model, (2, 32, 32, 3), seed=0, device=cuda)
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1)).to(cuda)
    before = (layer_norm.launches, layer_norm_backward.launches)
    train_step(state, x, (x.mean(-1) > 0).long(), ConfusionAccumulator.init(2, cuda))
    torch.cuda.synchronize()
    assert (layer_norm.launches - before[0], layer_norm_backward.launches - before[1]) == (10, 10)
