"""The port's B8 kernel (the fused NATT interior) and the serving options
``natt_int8``, ``ln_fold`` and ``skip_compose`` against the JAX package.

On the CPU, float32 unless it says otherwise, TINY weights filled from a
numpy seed (``test_torch_serve.jax_variables``):
  * ``natt_flat_interior`` (its plain version on CPU tensors) against JAX's
    unfused interior (``tests/test_natt_flat.py``'s reference) at natt4 and
    natt3, and once against JAX's kernel in interpret mode;
  * ``deploy_forward`` with each option against JAX's with the same option,
    and the options' own checks (exclusive flags, the composed kernel's size).

Also on the CPU: the bf16 weight pack, the plain version that rounds where
the bf16 kernel does against JAX's kernel on bf16 emb and against the
float32 plain version, and ``natt_plan`` at every shape the paths give B8.

On a CUDA card (marker ``gpu``; skipped without one): B8 against its plain
versions (bf16 two ways), its launch count, its input checks, and
``natt_plan`` against the kernel's own plan.
``python -m pytest --noconftest -m gpu tests/test_torch_natt.py`` runs them
there; the JAX comparisons import JAX inside the test.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lmnet_tpu_torch.ops.natt_flat import (
    MAX_SMEM,
    TC_THREADS,
    fold_natt_weights,
    kernel_natt_plan,
    natt_flat_interior,
    natt_flat_interior_plain,
    natt_plan,
    pack_natt_weights,
    pack_natt_weights_bf16,
    tc_dims,
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


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_natt", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_SMOKE = _chip_smoke()


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
    fw["packed_bf16"] = pack_natt_weights_bf16(fw)
    return fw


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,heads,hd", _SMOKE.B8_SHAPES)
def test_b8_kernel_matches_plain_on_card(cuda, dtype, B, H, W, heads, hd):
    """B8 against ``natt_flat_interior_plain`` on the same (bf16-rounded)
    input, by ``chip_smoke.check_b8`` (phase 16's check): f32 within 1e-4
    (1 + max|ref|); bf16 within 2^-7 max|ref| of the plain version rounding
    at the kernel's points and within 2x that version's distance + 2^-8
    max|ref| of the float32 one."""
    C = heads * hd
    fw = _random_fw(C + H, C, heads, cuda)
    emb = torch.randn(B, H, W * C, generator=torch.Generator().manual_seed(H * W)).to(cuda, dtype)
    before = natt_flat_interior.launches
    got = natt_flat_interior(emb, fw, heads, C, W)
    torch.cuda.synchronize()
    assert natt_flat_interior.launches == before + 1
    assert got.dtype == dtype and got.shape == emb.shape
    _SMOKE.check_b8("test", emb, fw, heads, C, W, got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b8_kernel_takes_an_offset_view(cuda, dtype):
    """emb as a contiguous view whose data starts 2 or 4 bytes off 16 (the
    kernel copies emb in 16-byte units): the same output as on an aligned
    copy, one launch."""
    B, H, W, heads, C = 2, 16, 24, 12, 24
    fw = _random_fw(5, C, heads, cuda)
    emb = torch.randn(B, H, W * C, generator=torch.Generator().manual_seed(3)).to(cuda, dtype)
    view = torch.empty(emb.numel() + 1, dtype=dtype, device=cuda)[1:].view(emb.shape)
    view.copy_(emb)
    assert view.is_contiguous() and view.data_ptr() % 16
    want = natt_flat_interior(emb, fw, heads, C, W)
    before = natt_flat_interior.launches
    got = natt_flat_interior(view, fw, heads, C, W)
    torch.cuda.synchronize()
    assert natt_flat_interior.launches == before + 1 and torch.equal(got, want)


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_python_natt_plan_is_the_kernels_plan(cuda, dtype):
    """natt_plan and csrc/natt_flat.cu's plan are one function: equal at
    every shape of PLAN_SHAPES, and both refuse the same shapes."""
    for B, H, W, heads, hd in [*PLAN_SHAPES, (1, 2, 8, 2, 2), (0, 8, 8, 2, 2), (1, 8, 8, 0, 2)]:
        assert kernel_natt_plan(B, H, W, heads, hd, dtype) == natt_plan(
            B, H, W, heads, hd, dtype), (B, H, W, heads, hd)


# --------------------------------------------------------------------------
# the bf16 kernel's weights, rounding points and plans (CPU)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("C,heads", [(12, 12), (24, 12), (96, 12), (4, 2), (12, 4), (32, 2)])
def test_pack_natt_weights_bf16_lays_out_the_rounded_weights(C, heads):
    """Each matrix unpacked from the bf16 buffer is the float32 weight
    rounded to bf16, in (out, in) layout, with zero padding to (nc or n2,
    kc + 8 or k2 + 8); the buffer holds nothing else."""
    fw = _random_fw(C, C, heads, "cpu")
    d = tc_dims(C, heads, (1, 1), C)
    buf, off = fw["packed_bf16"], 0
    assert buf.dtype == torch.bfloat16
    for name, n, k in [("wq", d["nc"], d["sa"]), ("wk", d["nc"], d["sa"]),
                       ("wv", d["nc"], d["sa"]), ("wp", d["nc"], d["sa"]),
                       ("w1", d["n2"], d["sa"]), ("w2", d["nc"], d["s4"])]:
        m = buf[off:off + n * k].reshape(n, k)
        w = fw[name]
        assert torch.equal(m[:w.shape[0], :w.shape[1]], w.to(torch.bfloat16)), name
        assert not m[w.shape[0]:].any() and not m[:, w.shape[1]:].any(), name
        off += n * k
    assert off == buf.numel()


def test_b8_plain_bf16_rounding_matches_jax_kernel(deploy_pair):
    """The plain version at the bf16 kernel's rounding points (bf16 emb)
    against JAX ``natt_flat_interior(bf16 emb, interpret=True)`` at TINY
    natt4 and natt3, 8x8, B=2. JAX's kernel computes in float32 from the
    bf16 emb and rounds only its output; this version also rounds the
    weights and the four A operands to bf16 (2^-9 relative each), through
    sums of up to 2C products: measured 0.5-0.8 % of max|ref|, bound 3e-2
    max|ref|."""
    import jax.numpy as jnp
    from lmnet_tpu.ops.pallas.natt_flat import fold_natt_weights as j_fold
    from lmnet_tpu.ops.pallas.natt_flat import natt_flat_interior as j_natt

    jd, sd, _ = deploy_pair
    for name, C in (("natt4", 4), ("natt3", 8)):
        H = W = 8
        emb = torch.from_numpy((np.random.RandomState(3).randn(2, H, W * C) * 0.5)
                               .astype(np.float32)).bfloat16()
        want = np.asarray(j_natt(jnp.asarray(emb.float().numpy()).astype(jnp.bfloat16),
                                 j_fold(jd["params"][name], C, W, HEADS), HEADS, C, W,
                                 interpret=True).astype(jnp.float32))
        got = natt_flat_interior(emb, fold_natt_weights(sd, name, HEADS), HEADS, C, W)
        assert got.dtype == torch.bfloat16 and got.shape == emb.shape
        err = np.abs(got.float().numpy() - want).max()
        assert err <= 3e-2 * np.abs(want).max(), (name, err, np.abs(want).max())


@pytest.mark.parametrize("B,H,W,heads,hd", [(1, 8, 8, 12, 1), (1, 6, 7, 12, 2), (1, 5, 5, 12, 4),
                                             (1, 4, 4, 12, 8), (1, 5, 6, 4, 3)])
def test_b8_plain_bf16_rounding_against_float32(B, H, W, heads, hd):
    """The plain version that rounds at the bf16 kernel's points against
    the float32 plain version on the same bf16 emb: it differs (it rounds),
    by at most 2^-5 max|ref| (bf16 weights and A operands, 2^-9 relative
    each, through sums of up to 2C = 192 products and two LayerNorms). That
    distance is what the card's bound scales by."""
    C = heads * hd
    fw = _random_fw(C + H, C, heads, "cpu")
    emb = torch.randn(B, H, W * C, generator=torch.Generator().manual_seed(H * W)).bfloat16()
    r = natt_flat_interior_plain(emb, fw, heads, C, W)
    f = natt_flat_interior_plain(emb.float(), fw, heads, C, W)
    assert r.dtype == torch.bfloat16 and f.dtype == torch.float32
    m = f.abs().max().item()
    dist = (r.float() - f).abs().max().item()
    assert 0 < dist <= 2**-5 * m, (dist, m)


# every shape the paths give B8: the four NATT stages at 256^2 and 288^2
# (B=16, 12 heads), B8_SHAPES, and odd maps (5x5, 28^2, a W=7 strip, 3x3,
# head_dim 3 and 16)
PLAN_SHAPES = sorted({(16, h, w, 12, c // 12) for h, w, c in _SMOKE.STAGES_256 + _SMOKE.STAGES_288}
                     | {tuple(s) for s in _SMOKE.B8_SHAPES}
                     | {(2, 5, 5, 12, 4), (2, 28, 28, 12, 2), (2, 32, 7, 12, 4), (1, 3, 3, 12, 1),
                        (1, 9, 9, 4, 3), (1, 12, 10, 6, 16)})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,heads,hd", PLAN_SHAPES)
def test_natt_plan_fits(dtype, B, H, W, heads, hd):
    """B8's plan: shared memory within the block limit; bf16: the group
    divides C into whole heads (a multiple of 8 unless it is C), at most
    TC_THREADS heads, the halo indexable in 10 bits, emb's copy unit the
    widest that divides C's bf16 run, the regions of ``tc_dims``; at the
    four 256^2 stages two blocks fit an SM and the tile holds at least 64
    pixels."""
    C = heads * hd
    plan = natt_plan(B, H, W, heads, hd, dtype)
    assert plan is not None and 0 < plan["smem"] <= MAX_SMEM
    tr, tc = plan["tile"]
    if dtype == torch.float32:
        assert plan["group"] == C and plan["vec"] == 0
        assert plan["smem"] == (4 * (tr + 2) * (tc + 2) + tr * tc) * C * 4
        return
    g = plan["group"]
    assert C % g == 0 and g % hd == 0 and (g == C or g % 8 == 0) and g // hd <= TC_THREADS
    assert (tr + 2) * (tc + 2) <= 1023
    vec = plan["vec"]
    assert vec in (2, 4, 8, 16) and (2 * C) % vec == 0 and (vec == 16 or (2 * C) % (2 * vec))
    d = tc_dims(C, heads, plan["tile"], g)
    assert plan["smem"] == d["smem"] == sum(-(-v // 16) * 16 for v in d["regions"].values())
    if (H, W) in ((256, 256), (128, 128), (64, 64), (32, 32)):
        assert plan["smem"] <= 113 * 1024 and tr * tc >= 64


def test_natt_plan_picks_the_stage_tiles_and_refuses():
    """The tiles the kernel's note names, and the shapes it refuses."""
    got = {c: natt_plan(16, h, w, 12, c // 12, torch.bfloat16)
           for h, w, c in [(256, 256, 12), (128, 128, 24), (64, 64, 48), (32, 32, 96)]}
    assert [(p["tile"], p["group"]) for p in got.values()] == [
        ((16, 16), 12), ((16, 16), 8), ((8, 16), 24), ((8, 8), 24)]
    assert natt_plan(1, 2, 8, 2, 2, torch.bfloat16) is None  # H < 3
    assert natt_plan(1, 8, 8, 2, 2, torch.float16) is None
    assert natt_plan(0, 8, 8, 2, 2, torch.float32) is None
