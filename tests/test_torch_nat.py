"""Neighborhood attention in the PyTorch port.

On the CPU: the port's plain ``neighborhood_attention`` against the JAX op
and the brute-force oracle, and the port's ``nat_flat`` (which takes the
plain version for CPU tensors) against JAX ``nat_flat(..., interpret=True)``.
Float32 throughout, rtol 1e-4 / atol 1e-5.

The backward: the port's plain backward ``nat_flat_bwd_plain`` against JAX
``nat_flat_bwd(..., interpret=True)`` (rtol/atol 1e-4, the JAX test's own
bound) and against ``jax.vjp`` of the XLA reference at the shapes JAX sends
there; autograd through the CPU ``nat_flat`` against it.

On a CUDA card (marker ``gpu``; skipped without one): the hand-written
forward and backward kernels against the plain versions, the backward's
bitwise determinism, its launch count and its input checks. Those tests
import no JAX, so on the card they run with
``python -m pytest --noconftest -m gpu tests/test_torch_nat.py``; the JAX
comparisons import JAX inside the test.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

from lmnet_tpu_torch.ops import _build
from lmnet_tpu_torch.ops.nat import neighborhood_attention
from lmnet_tpu_torch.ops.nat_flat import nat_flat, nat_flat_bwd, nat_flat_bwd_plain

RTOL, ATOL = 1e-4, 1e-5


def _qkv(rng, B, H, W, C, heads, k=3):
    q, k_, v = (rng.randn(B, H, W, C).astype(np.float32) for _ in range(3))
    rpb = (rng.randn(heads, 2 * k - 1, 2 * k - 1) * 0.3).astype(np.float32)
    return q, k_, v, rpb


@pytest.mark.parametrize(
    "hw,heads,hd,ksize",
    [
        ((6, 7), 2, 3, 3),   # non-square, head_dim 3
        ((5, 5), 3, 1, 3),   # head_dim 1
        ((8, 6), 2, 4, 5),   # k = 5
        ((3, 9), 1, 2, 3),   # a 3-row map: every row is a border row
    ],
)
def test_plain_nat_matches_jax_and_bruteforce(hw, heads, hd, ksize):
    from lmnet_tpu.ops.nat import neighborhood_attention as jax_nat
    from test_nat import naive_nat

    H, W = hw
    q, k, v, rpb = _qkv(np.random.RandomState(0), 2, H, W, heads * hd, heads, ksize)
    got = neighborhood_attention(*map(torch.from_numpy, (q, k, v, rpb)), ksize).numpy()
    np.testing.assert_allclose(got, naive_nat(q, k, v, rpb, ksize), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(jax_nat(q, k, v, rpb, ksize)),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(
    "hw,heads,hd",
    [
        ((16, 8), 3, 1),    # the four shapes of tests/test_nat_flat.py
        ((16, 8), 2, 4),
        ((32, 16), 12, 2),
        ((8, 8), 2, 2),
        ((12, 8), 2, 2),    # H=12: JAX sends it to XLA (rows < 8)
        ((8, 8), 2, 3),     # head_dim 3: JAX sends it to XLA
    ],
)
def test_nat_flat_cpu_matches_jax_nat_flat(hw, heads, hd):
    import jax.numpy as jnp
    from lmnet_tpu.ops.pallas.nat_flat import nat_flat as jax_nat_flat

    H, W = hw
    C, B = heads * hd, 2
    q, k, v, rpb = _qkv(np.random.RandomState(1), B, H, W, C, heads)
    flat = [a.reshape(B, H, W * C) for a in (q, k, v)]
    want = jax_nat_flat(*map(jnp.asarray, flat), jnp.asarray(rpb), heads, C, W, None, True)
    before = nat_flat.launches
    got = nat_flat(*map(torch.from_numpy, flat), torch.from_numpy(rpb), heads, C, W)
    assert nat_flat.launches == before  # the CPU path launches no kernel
    assert got.shape == (B, H, W * C) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_nat_flat_scale_argument():
    rng = np.random.RandomState(2)
    q, k, v, rpb = _qkv(rng, 1, 6, 5, 4, 2)
    t = [torch.from_numpy(a.reshape(1, 6, 20)) for a in (q, k, v)]
    got = nat_flat(*t, torch.from_numpy(rpb), 2, 4, 5, scale=0.3)
    want = neighborhood_attention(*map(torch.from_numpy, (q, k, v, rpb)), 3, scale=0.3)
    torch.testing.assert_close(got, want.reshape(1, 6, 20), rtol=0, atol=0)


@pytest.mark.parametrize(
    "bad",
    ["wc", "heads", "rpb", "kshape", "rank"],
)
def test_nat_flat_rejects_inconsistent_inputs(bad):
    q = torch.zeros(1, 4, 4 * 6)
    k = v = q
    rpb = torch.zeros(2, 5, 5)
    args = dict(q=q, k=k, v=v, rpb=rpb, heads=2, C=6, W=4)
    args.update({
        "wc": dict(W=5),
        "heads": dict(heads=4, rpb=torch.zeros(4, 5, 5)),
        "rpb": dict(rpb=torch.zeros(2, 3, 3)),
        "kshape": dict(k=torch.zeros(1, 4, 30)),
        "rank": dict(q=q.reshape(1, 4, 4, 6)),
    }[bad])
    with pytest.raises(ValueError):
        nat_flat(**args)


# the shapes of tests/test_nat_flat.py::test_nat_flat_bwd_kernel_matches_xla_vjp
BWD_KERNEL_SHAPES = [((32, 8), 3, 1), ((16, 8), 2, 4), ((8, 8), 2, 2), ((16, 4), 1, 4)]
# shapes JAX's nat_flat_bwd sends to the XLA vjp (rows < 8, head_dim 3, H < 8)
BWD_FALLBACK_SHAPES = [((28, 8), 2, 3), ((3, 3), 2, 2), ((28, 28), 3, 2)]


def _bwd_case(seed, B, H, W, heads, hd):
    rng = np.random.RandomState(seed)
    C = heads * hd
    q, k, v, g = (rng.randn(B, H, W * C).astype(np.float32) for _ in range(4))
    rpb = (rng.randn(heads, 5, 5) * 0.3).astype(np.float32)
    return q, k, v, rpb, g, C


@pytest.mark.parametrize("hw,heads,hd", BWD_KERNEL_SHAPES)
def test_plain_bwd_matches_jax_bwd_kernel(hw, heads, hd):
    """nat_flat_bwd_plain == JAX nat_flat_bwd(interpret=True), the fused
    Pallas backward, for dq, dk, dv and d_rpb at rtol/atol 1e-4."""
    import jax.numpy as jnp
    from lmnet_tpu.ops.pallas.nat_flat import nat_flat_bwd as jax_bwd

    H, W = hw
    q, k, v, rpb, g, C = _bwd_case(3, 2, H, W, heads, hd)
    scale = float(hd) ** -0.5
    want = jax_bwd(*map(jnp.asarray, (q, k, v, rpb, g)), heads, C, W, scale, interpret=True)
    got = nat_flat_bwd_plain(*map(torch.from_numpy, (q, k, v, rpb, g)), heads, C, W, scale)
    for name, a, b in zip(("dq", "dk", "dv", "drpb"), got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("hw,heads,hd", BWD_FALLBACK_SHAPES)
def test_plain_bwd_matches_jax_vjp(hw, heads, hd):
    """At the shapes where JAX's backward is the vjp of its XLA reference,
    the plain backward equals that vjp (rtol/atol 1e-4); ``nat_flat_bwd``
    on CPU tensors is the plain backward and launches nothing."""
    import jax
    import jax.numpy as jnp
    from lmnet_tpu.ops.pallas.nat_flat import _nat_flat_ref

    H, W = hw
    q, k, v, rpb, g, C = _bwd_case(4, 2, H, W, heads, hd)
    scale = float(hd) ** -0.5
    _, vjp = jax.vjp(lambda *a: _nat_flat_ref(*a, heads, C, W, scale),
                     *map(jnp.asarray, (q, k, v, rpb)))
    want = vjp(jnp.asarray(g))
    before = nat_flat_bwd.launches
    got = nat_flat_bwd(*map(torch.from_numpy, (q, k, v, rpb, g)), heads, C, W, scale)
    assert nat_flat_bwd.launches == before
    for name, a, b in zip(("dq", "dk", "dv", "drpb"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4, err_msg=name)


def test_cpu_autograd_through_nat_flat_equals_plain_bwd():
    """On the CPU, autograd through ``nat_flat`` (the plain forward) gives
    the plain backward's gradients exactly (the same graph)."""
    q, k, v, rpb, g, C = _bwd_case(5, 2, 7, 6, 2, 3)
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, rpb)]
    out = nat_flat(*t, 2, C, 6)
    got = torch.autograd.grad(out, t, torch.from_numpy(g))
    want = nat_flat_bwd_plain(*map(torch.from_numpy, (q, k, v, rpb, g)), 2, C, 6, 3**-0.5)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_nat_flat_bwd_rejects_a_wrong_cotangent():
    q, k, v, rpb, g, C = _bwd_case(6, 1, 4, 4, 2, 2)
    t = list(map(torch.from_numpy, (q, k, v, rpb)))
    with pytest.raises(ValueError):
        nat_flat_bwd(*t, torch.from_numpy(g[:, :3]), 2, C, 4, 0.5)


def test_build_targets_sm90a_and_hashes_the_source():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    path = _build.library_path("nat_fwd")
    assert path == _build.library_path("nat_fwd")  # deterministic
    assert path.parent == _build.BUILD_DIR and path.name.startswith("nat_fwd-")
    assert (_build.CSRC / "nat_fwd.cu").is_file()


def test_build_hashes_each_source_apart():
    """The backward kernel has its own source and its own library name."""
    fwd, bwd = _build.library_path("nat_fwd"), _build.library_path("nat_bwd")
    assert bwd.name.startswith("nat_bwd-") and bwd.parent == fwd.parent and bwd != fwd
    assert (_build.CSRC / "nat_bwd.cu").is_file()


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


def _flat_case(device, dtype, B, H, W, heads, hd, seed=0):
    C = heads * hd
    q, k, v, rpb = _qkv(np.random.RandomState(seed), B, H, W, C, heads)
    flat = [torch.from_numpy(a.reshape(B, H, W * C)).to(device, dtype) for a in (q, k, v)]
    return flat, torch.from_numpy(rpb).to(device), C


# shapes that exercise the tiled kernels' edges: a W that is no multiple of
# the 32-column tile, C = 12 at head_dim 1 (a 24-byte bf16 pixel, 8-byte
# copies), H = W = 3, W = 4, B = 1, head_dim 3 (the generic variant) and one
# 256^2 stage at B = 2
TILE_SHAPES = [(1, 20, 37, 12, 1), (2, 9, 17, 12, 1), (1, 3, 3, 12, 1), (2, 16, 4, 12, 4),
               (1, 33, 40, 12, 2), (1, 12, 12, 12, 3), (2, 256, 256, 12, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,H,W,heads,hd",
    [(2, 3, 3, 2, 2), (1, 28, 28, 12, 3), (2, 9, 17, 3, 1), (1, 16, 8, 2, 8), (1, 5, 7, 1, 16)]
    + TILE_SHAPES,
)
def test_kernel_matches_plain_on_card(cuda, dtype, B, H, W, heads, hd):
    """Kernel vs the plain version on the same (bf16-rounded) inputs in
    float32: f32 within 1e-5 abs; bf16 within 2**-7 relative of the output
    scale (one bf16 rounding of the stored result) plus 1e-3."""
    (q, k, v), rpb, C = _flat_case(cuda, dtype, B, H, W, heads, hd)
    before = nat_flat.launches
    got = nat_flat(q, k, v, rpb, heads, C, W)
    torch.cuda.synchronize()
    assert nat_flat.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = neighborhood_attention(
        *(t.float().reshape(B, H, W, C) for t in (q, k, v)), rpb, 3
    ).reshape(B, H, W * C)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        err = (got.float() - want).abs().max().item()
        assert err <= 2**-7 * want.abs().max().item() + 1e-3, err


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    (q, k, v), rpb, C = _flat_case(cuda, torch.float32, 1, 4, 4, 2, 2)
    with pytest.raises(ValueError):  # fp16 is not a kernel dtype
        nat_flat(q.half(), k.half(), v.half(), rpb, 2, C, 4)
    with pytest.raises(ValueError):  # k on another dtype
        nat_flat(q, k.bfloat16(), v, rpb, 2, C, 4)
    with pytest.raises(ValueError):  # non-contiguous q
        qt = q.transpose(1, 2).contiguous().transpose(1, 2)
        nat_flat(qt, k, v, rpb, 2, C, 4)
    with pytest.raises(ValueError):  # rpb not float32
        nat_flat(q, k, v, rpb.bfloat16(), 2, C, 4)
    (q2, k2, v2), rpb2, C2 = _flat_case(cuda, torch.float32, 1, 2, 4, 2, 2)
    with pytest.raises(ValueError):  # fewer than 3 rows
        nat_flat(q2, k2, v2, rpb2, 2, C2, 4)


def _bwd_on_card(device, dtype, B, H, W, heads, hd, seed=0):
    q, k, v, rpb, g, C = _bwd_case(seed, B, H, W, heads, hd)
    flat = [torch.from_numpy(a).to(device, dtype) for a in (q, k, v, g)]
    return flat, torch.from_numpy(rpb).to(device), C


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,H,W,heads,hd",
    [(2, h, w, n, d) for (h, w), n, d in BWD_KERNEL_SHAPES + BWD_FALLBACK_SHAPES]
    + [(1, 16, 8, 2, 8), (1, 5, 7, 1, 16), (2, 32, 32, 12, 8)] + TILE_SHAPES,
)
def test_bwd_kernel_matches_plain_on_card(cuda, dtype, B, H, W, heads, hd):
    """The CUDA backward against ``nat_flat_bwd_plain`` in float32 on the
    same (bf16-rounded) inputs. dq/dk/dv per element: f32 within
    1e-5 * (1 + max|ref|) (summation order); bf16 within 2**-8 * |ref| +
    1e-4 * (1 + max|ref|) (one bf16 rounding of the store). d_rpb, a sum over
    B*H*W pixels, in norm: ||err|| <= 1e-4 * ||ref||."""
    (q, k, v, g), rpb, C = _bwd_on_card(cuda, dtype, B, H, W, heads, hd)
    scale = float(hd) ** -0.5
    before = nat_flat_bwd.launches
    got = nat_flat_bwd(q, k, v, rpb, g, heads, C, W, scale)
    torch.cuda.synchronize()
    assert nat_flat_bwd.launches == before + 1
    want = nat_flat_bwd_plain(*(t.float() for t in (q, k, v)), rpb, g.float(), heads, C, W, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        assert a.dtype == dtype and a.shape == q.shape, name
        err = (a.float() - b).abs()
        bound = 1e-5 * (1 + b.abs().max()) if dtype == torch.float32 else (
            2**-8 * b.abs() + 1e-4 * (1 + b.abs().max()))
        assert bool((err <= bound).all()), (name, err.max().item())
    assert got[3].dtype == torch.float32 and got[3].shape == rpb.shape
    assert (got[3] - want[3]).norm() <= 1e-4 * want[3].norm()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,heads,hd", [(2, 64, 64, 12, 4)] + TILE_SHAPES)
def test_bwd_kernel_is_bitwise_deterministic(cuda, dtype, B, H, W, heads, hd):
    (q, k, v, g), rpb, C = _bwd_on_card(cuda, dtype, B, H, W, heads, hd, seed=1)
    a = nat_flat_bwd(q, k, v, rpb, g, heads, C, W, 0.5)
    b = nat_flat_bwd(q, k, v, rpb, g, heads, C, W, 0.5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("field", ["threads", "smem", "heads_per_block", "tile", "vec_bytes"])
def test_kernels_refuse_a_plan_that_is_not_theirs(cuda, monkeypatch, kind, field):
    """The C entry computes its own launch plan and refuses (CUDA error 1,
    cudaErrorInvalidValue) one that differs: the wrapper raises and counts
    no launch."""
    nf = importlib.import_module("lmnet_tpu_torch.ops.nat_flat")
    (q, k, v, g), rpb, C = _bwd_on_card(cuda, torch.bfloat16, 1, 20, 37, 12, 1)
    good = nf.nat_plan(1, 20, 37, 12, 1, torch.bfloat16, kind)
    bad = dict(good, **{field: (good[field][0] // 2, good[field][1]) if field == "tile"
                        else good[field] // 2})
    monkeypatch.setattr(nf, "nat_plan", lambda *a: bad)
    # a fresh cache of the C arguments, made from the patched plan
    monkeypatch.setattr(nf, "_plan_args", functools.lru_cache(None)(nf._plan_args.__wrapped__))
    counter = nat_flat if kind == "fwd" else nat_flat_bwd
    before = counter.launches
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        if kind == "fwd":
            with torch.no_grad():
                nat_flat(q, k, v, rpb, 12, C, 37)
        else:
            nat_flat_bwd(q, k, v, rpb, g, 12, C, 37, 1.0)
    assert counter.launches == before


@pytest.mark.gpu
def test_autograd_on_card_launches_both_kernels(cuda):
    """One forward and one backward through ``nat_flat`` launch each kernel
    once, and the gradients are the backward kernel's."""
    (q, k, v, g), rpb, C = _bwd_on_card(cuda, torch.float32, 1, 9, 10, 3, 2, seed=2)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, rpb)]
    f0, b0 = nat_flat.launches, nat_flat_bwd.launches
    out = nat_flat(*leaves, 3, C, 10)
    grads = torch.autograd.grad(out, leaves, g)
    assert (nat_flat.launches, nat_flat_bwd.launches) == (f0 + 1, b0 + 1)
    want = nat_flat_bwd(q, k, v, rpb, g, 3, C, 10, 2**-0.5)
    assert all(torch.equal(x, y) for x, y in zip(grads, want))


@pytest.mark.gpu
def test_bwd_kernel_rejects_what_it_does_not_take(cuda):
    (q, k, v, g), rpb, C = _bwd_on_card(cuda, torch.float32, 1, 4, 4, 2, 2)
    with pytest.raises(ValueError):  # g on another dtype
        nat_flat_bwd(q, k, v, rpb, g.bfloat16(), 2, C, 4, 0.5)
    with pytest.raises(ValueError):  # non-contiguous g
        gt = g.transpose(1, 2).contiguous().transpose(1, 2)
        nat_flat_bwd(q, k, v, rpb, gt, 2, C, 4, 0.5)
    with pytest.raises(ValueError):  # g of another shape
        nat_flat_bwd(q, k, v, rpb, g[:, :3].contiguous(), 2, C, 4, 0.5)
    with pytest.raises(ValueError):  # fp16
        nat_flat_bwd(q.half(), k.half(), v.half(), rpb, g.half(), 2, C, 4, 0.5)
