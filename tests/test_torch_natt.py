"""The port's B8 kernel (the fused NATT interior) and the serving options
``natt_int8``, ``ln_fold`` and ``skip_compose`` against the JAX package.

On the CPU, float32 unless it says otherwise, TINY weights filled from a
numpy seed (``test_torch_serve.jax_variables``):
  * ``natt_flat_interior`` (its plain version on CPU tensors) against JAX's
    unfused interior (``tests/test_natt_flat.py``'s reference) at natt4 and
    natt3, and once against JAX's kernel in interpret mode;
  * ``deploy_forward`` with each option against JAX's with the same option,
    and the options' own checks (exclusive flags, the composed kernel's size).

On a CUDA card (marker ``gpu``; skipped without one): B8 against its plain
version, its launch count and its input checks.
``python -m pytest --noconftest -m gpu tests/test_torch_natt.py`` runs them
there; the JAX comparisons import JAX inside the test.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lmnet_tpu_torch.ops.natt_flat import (
    fold_natt_weights,
    natt_flat_interior,
    natt_flat_interior_plain,
    pack_natt_weights,
)

HEADS = 2  # TINY's


@pytest.fixture(scope="module")
def deploy_pair():
    """TINY deploy variables at 32^2: JAX's, the port's, and the raw ones."""
    import jax
    from lmnet_tpu.models import structural_reparam as j_reparam
    from test_torch_serve import jax_variables

    from lmnet_tpu_torch.convert import jax_to_state_dict
    from lmnet_tpu_torch.models import structural_reparam

    variables = jax_variables(0, 32)
    return (jax.device_get(j_reparam(variables)),
            structural_reparam(jax_to_state_dict(variables)), variables)


def _jax_interior(p, emb):
    """The unfused JAX serve-path interior (tests/test_natt_flat.py)."""
    import jax.numpy as jnp
    from lmnet_tpu.ops.nat import neighborhood_attention
    from lmnet_tpu.serve import engine as se

    ln1 = se._ln(p["norm1"], emb)
    q, k, v = jnp.split(se._dense(p["attn"]["qkv"], ln1), 3, axis=-1)
    att = se._dense(p["attn"]["proj"], neighborhood_attention(q, k, v, p["attn"]["rpb"], 3)) + emb
    return se._mlp(p["mlp"], se._ln(p["norm2"], att)) + att


@pytest.mark.parametrize("name,B,H,W", [("natt4", 2, 16, 16), ("natt3", 2, 16, 16),
                                        ("natt4", 1, 8, 8), ("natt3", 1, 9, 5)])
def test_b8_plain_matches_jax_unfused_interior(deploy_pair, name, B, H, W):
    """TINY natt4 (C=4, head_dim 2) and natt3 (C=8, head_dim 4) at 16^2, 8x8
    (one stripe in JAX) and 9x5: rtol 2e-4 / atol 2e-4
    (tests/test_natt_flat.py's bound)."""
    import jax.numpy as jnp

    jd, sd, _ = deploy_pair
    p = jd["params"][name]
    C = p["attn"]["qkv"]["dense"]["kernel"].shape[0]
    emb = (np.random.RandomState(H + C).randn(B, H, W, C) * 0.5).astype(np.float32)
    want = np.asarray(_jax_interior(p, jnp.asarray(emb)))
    fw = fold_natt_weights(sd, name, HEADS)
    before = natt_flat_interior.launches
    got = natt_flat_interior(torch.from_numpy(emb.reshape(B, H, W * C)), fw, HEADS, C, W)
    assert natt_flat_interior.launches == before  # the CPU path launches no kernel
    assert got.shape == (B, H, W * C) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy().reshape(B, H, W, C), want, rtol=2e-4, atol=2e-4)


def test_b8_plain_matches_jax_kernel(deploy_pair):
    """Against JAX ``natt_flat_interior(interpret=True)`` at 8x8 (one
    stripe): rtol 2e-4 / atol 2e-4. JAX's kernel takes the LN variance as
    E[x^2] - E[x]^2, the port E[(x - mean)^2]."""
    import jax.numpy as jnp
    from lmnet_tpu.ops.pallas.natt_flat import fold_natt_weights as j_fold
    from lmnet_tpu.ops.pallas.natt_flat import natt_flat_interior as j_natt

    jd, sd, _ = deploy_pair
    p = jd["params"]["natt4"]
    C, H, W = 4, 8, 8
    emb = (np.random.RandomState(3).randn(1, H, W * C) * 0.5).astype(np.float32)
    want = j_natt(jnp.asarray(emb), j_fold(p, C, W, HEADS), HEADS, C, W, interpret=True)
    got = natt_flat_interior(torch.from_numpy(emb), fold_natt_weights(sd, "natt4", HEADS),
                             HEADS, C, W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_fold_natt_weights_carries_the_nat_scale(deploy_pair):
    _, sd, _ = deploy_pair
    fw = fold_natt_weights(sd, "natt3", HEADS)
    C = 8
    w = sd["natt3.att1.qkv.weight"]
    torch.testing.assert_close(fw["wq"], w[:C] * (C // HEADS) ** -0.5)
    torch.testing.assert_close(fw["wk"], w[C:2 * C])
    assert fw["w1"].shape == (2 * C, C) and fw["rpb"].shape == (HEADS, 5, 5)
    # the kernel's buffer, packed once: six matrices (in, out), ten vectors, rpb
    assert fw["packed"].shape == (8 * C * C + 11 * C + HEADS * 25,)
    torch.testing.assert_close(fw["packed"][:C * C], fw["wq"].t().reshape(-1))
    torch.testing.assert_close(fw["packed"][-HEADS * 25:], fw["rpb"].reshape(-1))
    with pytest.raises(ValueError):  # the map must hold the 3x3 window
        natt_flat_interior(torch.zeros(1, 2, 4 * C), fw, HEADS, C, 4)
    with pytest.raises(ValueError):  # W*C must match
        natt_flat_interior(torch.zeros(1, 4, 5 * C), fw, HEADS, C, 4)


# --------------------------------------------------------------------------
# the serving options
# --------------------------------------------------------------------------


def _forwards(deploy_pair, seed=1, **opts):
    """JAX deploy_forward (nat 'xla', rc 'xla') and the port's, fp32 at 32^2,
    with the same options."""
    import jax.numpy as jnp
    from lmnet_tpu.serve import deploy_forward

    from lmnet_tpu_torch.serve import deploy_forward as t_deploy

    jd, sd, _ = deploy_pair
    x = np.random.RandomState(seed).randn(1, 32, 32, 3).astype(np.float32)
    want = np.asarray(deploy_forward(jd, jnp.asarray(x), num_heads=HEADS, nat_backend="xla",
                                     rc_backend="xla", **opts))
    with torch.no_grad():
        got = t_deploy(sd, torch.from_numpy(x), num_heads=HEADS, nat_backend="plain",
                       **opts).numpy()
    return got, want


@pytest.mark.parametrize("opt", ["ln_fold", "skip_compose"])
def test_deploy_options_match_jax(deploy_pair, opt):
    """``ln_fold`` and ``skip_compose`` against JAX's with the same flag,
    rtol 1e-4 / atol 1e-5 everywhere: the same weight math on both sides
    (the composition, border ring included)."""
    got, want = _forwards(deploy_pair, **{opt: True})
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_skip_compose_border_against_the_unfused_graph(deploy_pair):
    """The port's composed skips against its own two-pass blocks: each of the
    four skips equal inside its outermost ring (rtol 1e-5 / atol 1e-5; 2e-6
    measured), the ring within 0.5 max|ref| (measured 0.30 at most), and the
    logits within 0.3 max|ref| (0.22 measured at this seed; JAX's bound is
    0.5 max + 1). The ring spreads through the NATT blocks and the decoder
    convs, so at TINY sizes no logit is far enough from a border to be exact."""
    from lmnet_tpu_torch.serve import deploy_forward as t_deploy
    from lmnet_tpu_torch.serve import engine

    _, sd, _ = deploy_pair
    g = np.random.RandomState(4)

    def r(*shape):
        return torch.from_numpy(g.randn(*shape).astype(np.float32))

    m2 = (engine._m2skip, engine._m2skip_composed)
    m3 = (engine._m3skip, engine._m3skip_composed)
    cases = [("skip1", m2, (r(1, 8, 8, 12), r(1, 4, 4, 16), "bottom")),
             ("skip4", m2, (r(1, 32, 32, 4), r(1, 16, 16, 8), "top")),
             ("skip2", m3, (r(1, 16, 16, 8), r(1, 8, 8, 12), r(1, 4, 4, 16))),
             ("skip3", m3, (r(1, 32, 32, 4), r(1, 16, 16, 8), r(1, 8, 8, 12)))]
    with torch.no_grad():
        for name, (two, one), args in cases:
            ref, out = two(sd, name, *args).numpy(), one(sd, name, *args).numpy()
            np.testing.assert_allclose(out[:, 1:-1, 1:-1], ref[:, 1:-1, 1:-1], rtol=1e-5,
                                       atol=1e-5, err_msg=name)
            assert np.abs(out - ref).max() <= 0.5 * np.abs(ref).max(), name
        x = torch.from_numpy(np.random.RandomState(1).randn(1, 32, 32, 3).astype(np.float32))
        ref = t_deploy(sd, x, num_heads=HEADS, nat_backend="plain").numpy()
        out = t_deploy(sd, x, num_heads=HEADS, nat_backend="plain", skip_compose=True).numpy()
    assert np.abs(out - ref).max() <= 0.3 * np.abs(ref).max(), np.abs(out - ref).max()


def test_natt_int8_matches_jax_and_tracks_the_float_graph(deploy_pair):
    """``natt_int8`` against JAX's int8 logits: the same quantisation on both
    sides, so equal up to float32 rounding except where a LayerNorm output
    sits on a rounding tie of the int8 step and one side rounds the other way
    (one step of that activation): |diff| <= 1e-3 (1 + |jax|) at 99.9 % of the
    logits, and max |diff| <= 0.05 max|jax|. Against the port's own float
    graph: mean relative error < 0.05, as tests/test_serve.py holds JAX's."""
    from lmnet_tpu_torch.serve import deploy_forward as t_deploy

    got, want = _forwards(deploy_pair, natt_int8=True)
    diff = np.abs(got - want)
    assert np.mean(diff <= 1e-3 * (1 + np.abs(want))) >= 0.999, diff.max()
    assert diff.max() <= 0.05 * np.abs(want).max(), diff.max()
    _, sd, _ = deploy_pair
    x = torch.from_numpy(np.random.RandomState(1).randn(1, 32, 32, 3).astype(np.float32))
    with torch.no_grad():
        ref = t_deploy(sd, x, num_heads=HEADS, nat_backend="plain").numpy()
    rel = np.abs(ref - got).mean() / (np.abs(ref).mean() + 1e-9)
    assert 0 < rel < 0.05, rel


def test_natt_int8_with_ln_fold_raises_and_compose_checks_the_size(deploy_pair):
    from lmnet_tpu_torch.serve import deploy_forward as t_deploy
    from lmnet_tpu_torch.serve.engine import _compose_kk

    _, sd, _ = deploy_pair
    with pytest.raises(ValueError, match="exclusive"):
        t_deploy(sd, torch.zeros(1, 32, 32, 3), num_heads=HEADS, natt_int8=True, ln_fold=True)
    k1, b1 = torch.randn(4, 3, 3, 3), torch.randn(4)
    K, bt = _compose_kk(k1, b1, torch.randn(5, 4, 3, 3))
    assert K.shape == (5, 3, 5, 5) and bt.shape == (5,)
    with pytest.raises(ValueError):  # 3 + 2 - 1 = 4: even, 'same' padding cannot centre it
        _compose_kk(k1, b1, torch.randn(5, 4, 2, 2))


def test_serving_evaluate_natt_int8_matches_jax(deploy_pair):
    """``serving_evaluate(natt_int8=True)`` in bf16 on both sides over the
    same synthetic batches, at test_torch_serve's bf16 bounds: loss 2 %
    relative, every metric 0.02."""
    from lmnet_tpu.data.datasets import SyntheticDataset, make_loader
    from lmnet_tpu.serve.engine import serving_evaluate

    from lmnet_tpu_torch.convert import jax_to_state_dict
    from lmnet_tpu_torch.data import SyntheticDataset as TSyntheticDataset
    from lmnet_tpu_torch.data import make_loader as t_make_loader
    from lmnet_tpu_torch.serve import serving_evaluate as t_serving_evaluate

    variables = deploy_pair[2]
    state = SimpleNamespace(params=variables["params"], batch_stats=variables["batch_stats"])
    j_loss, j_met = serving_evaluate(state, make_loader(SyntheticDataset(4, 32, "val", seed=3), 2),
                                     num_classes=2, img_size=32, num_heads=HEADS, natt_int8=True)
    t_loss, t_met = t_serving_evaluate(
        jax_to_state_dict(variables), t_make_loader(TSyntheticDataset(4, 32, "val", seed=3), 2),
        num_classes=2, img_size=32, num_heads=HEADS, natt_int8=True, device="cpu")
    assert np.isfinite(t_loss) and abs(t_loss - j_loss) <= 0.02 * abs(j_loss), (t_loss, j_loss)
    for k in j_met:
        assert abs(t_met[k] - j_met[k]) <= 0.02, (k, t_met[k], j_met[k])


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


def _random_fw(seed, C, heads, device):
    """``fold_natt_weights``-shaped float32 weights, fan-in scaled."""
    g = torch.Generator().manual_seed(seed)

    def n(*shape, s=1.0, base=0.0):
        return (base + torch.randn(*shape, generator=g) * s).to(device)

    fw = dict(wq=n(C, C, s=C**-0.5 * (C // heads) ** -0.5), bq=n(C, s=0.05),
              wk=n(C, C, s=C**-0.5), bk=n(C, s=0.1), wv=n(C, C, s=C**-0.5), bv=n(C, s=0.1),
              wp=n(C, C, s=C**-0.5), bp=n(C, s=0.1), w1=n(2 * C, C, s=C**-0.5),
              b1=n(2 * C, s=0.1), w2=n(C, 2 * C, s=(2 * C) ** -0.5), b2=n(C, s=0.1),
              ln1_w=n(C, s=0.1, base=1.0), ln1_b=n(C, s=0.1), ln2_w=n(C, s=0.1, base=1.0),
              ln2_b=n(C, s=0.1), rpb=n(heads, 5, 5, s=0.3))
    fw["packed"] = pack_natt_weights(fw)
    return fw


# (B, H, W, heads, head_dim): LM-Net's four NATT widths (12 heads), a 3x3
# map, head_dim 3, maps that end mid-tile
B8_SHAPES = [(2, 32, 32, 12, 1), (2, 16, 24, 12, 2), (1, 16, 16, 12, 4), (2, 8, 8, 12, 8),
             (1, 3, 3, 2, 2), (1, 11, 7, 4, 3), (1, 19, 21, 2, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,heads,hd", B8_SHAPES)
def test_b8_kernel_matches_plain_on_card(cuda, dtype, B, H, W, heads, hd):
    """B8 against ``natt_flat_interior_plain`` on the same (bf16-rounded)
    input in float32: f32 within 1e-4 (1 + max|ref|) (sums of up to 2C
    products and two LayerNorms in another order); bf16 within one rounding
    of the stored value more, 2^-8 |ref|."""
    C = heads * hd
    fw = _random_fw(C + H, C, heads, cuda)
    emb = torch.randn(B, H, W * C, generator=torch.Generator().manual_seed(H * W)).to(cuda, dtype)
    before = natt_flat_interior.launches
    got = natt_flat_interior(emb, fw, heads, C, W)
    torch.cuda.synchronize()
    assert natt_flat_interior.launches == before + 1
    assert got.dtype == dtype and got.shape == emb.shape
    want = natt_flat_interior_plain(emb.float(), fw, heads, C, W)
    bound = 1e-4 * (1 + want.abs().max())
    if dtype == torch.bfloat16:
        bound = bound + 2**-8 * want.abs()
    err = (got.float() - want).abs()
    assert bool((err <= bound).all()), err.max().item()


@pytest.mark.gpu
def test_b8_kernel_rejects_what_it_does_not_take(cuda):
    fw = _random_fw(0, 8, 2, cuda)
    emb = torch.randn(1, 6, 6 * 8, device=cuda)
    with pytest.raises(ValueError):  # fp16 is not a kernel dtype
        natt_flat_interior(emb.half(), fw, 2, 8, 6)
    with pytest.raises(ValueError):  # non-contiguous emb
        natt_flat_interior(emb.transpose(1, 2).contiguous().transpose(1, 2), fw, 2, 8, 6)
    with pytest.raises(ValueError):  # weights of another width
        natt_flat_interior(emb, _random_fw(0, 4, 2, cuda), 2, 8, 6)
    with pytest.raises(ValueError):  # packed weights on another device
        natt_flat_interior(emb, _random_fw(0, 8, 2, torch.device("cpu")), 2, 8, 6)
