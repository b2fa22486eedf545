"""Neighborhood attention in the PyTorch port.

On the CPU: the port's plain ``neighborhood_attention`` against the JAX op
and the brute-force oracle, and the port's ``nat_flat`` (which takes the
plain version for CPU tensors) against JAX ``nat_flat(..., interpret=True)``.
Float32 throughout, rtol 1e-4 / atol 1e-5.

On a CUDA card (marker ``gpu``; skipped without one): the hand-written
kernel against the plain version. Those tests import no JAX, so on the card
they run with ``python -m pytest --noconftest -m gpu tests/test_torch_nat.py``;
the JAX comparisons import JAX inside the test.
"""

import numpy as np
import pytest
import torch

from lmnet_tpu_torch.ops import _build
from lmnet_tpu_torch.ops.nat import neighborhood_attention
from lmnet_tpu_torch.ops.nat_flat import nat_flat

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


def test_build_targets_sm90a_and_hashes_the_source():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    path = _build.library_path("nat_fwd")
    assert path == _build.library_path("nat_fwd")  # deterministic
    assert path.parent == _build.BUILD_DIR and path.name.startswith("nat_fwd-")
    assert (_build.CSRC / "nat_fwd.cu").is_file()


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,H,W,heads,hd",
    [(2, 3, 3, 2, 2), (1, 28, 28, 12, 3), (2, 9, 17, 3, 1), (1, 16, 8, 2, 8), (1, 5, 7, 1, 16)],
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
