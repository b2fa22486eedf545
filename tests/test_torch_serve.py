"""The PyTorch port's serving slice against the JAX package, at TINY.

Both sides take the same weights: JAX variables are shaped with
``jax.eval_shape`` (no init compile) and filled from a numpy seed, then
converted with ``lmnet_tpu_torch.convert``. The port runs on the CPU, where
its NAT wrapper takes the plain version; the JAX reference for the deploy
graph is ``deploy_forward(nat_backend='xla', rc_backend='xla')``, which
computes the same function as the flat NAT kernel.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import TINY
from lmnet_tpu_torch.convert import jax_to_state_dict
from lmnet_tpu_torch.data import SyntheticDataset as TSyntheticDataset
from lmnet_tpu_torch.data import make_loader as t_make_loader
from lmnet_tpu_torch.models import LMNet as TLMNet
from lmnet_tpu_torch.models import structural_reparam as t_structural_reparam
from lmnet_tpu_torch.serve import deploy_forward as t_deploy_forward
from lmnet_tpu_torch.serve import serving_evaluate as t_serving_evaluate

HW = 64  # NAT stages at H = 8, 16, 32, 64
HEADS = TINY["num_heads"]


def jax_variables(seed: int = 0, hw: int = HW) -> dict:
    """TINY LMNet variables as nested dicts of numpy arrays, shaped by
    eval_shape and filled from ``np.random.RandomState(seed)``."""
    from lmnet_tpu.models import LMNet

    shapes = jax.eval_shape(
        lambda k: LMNet(**TINY).init(k, jnp.zeros((1, hw, hw, 3)), train=False),
        jax.random.key(0),
    )
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "var":
            a = rng.uniform(0.5, 2.0, shape)
        elif name == "mean":
            a = rng.normal(0.0, 0.5, shape)
        elif name == "scale":
            a = rng.uniform(0.5, 1.5, shape)
        elif name == "bias":
            a = rng.normal(0.0, 0.1, shape)
        elif name == "kernel":
            a = rng.normal(0.0, 1.0, shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "rpb":
            a = rng.normal(0.0, 0.3, shape)
        else:
            raise KeyError(name)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def variables():
    return jax_variables()


@pytest.fixture(scope="module")
def jax_deploy(variables):
    from lmnet_tpu.models import structural_reparam

    return jax.device_get(structural_reparam(variables))


@pytest.fixture(scope="module")
def port_model(variables):
    m = TLMNet(**TINY)
    m.load_state_dict(jax_to_state_dict(variables), strict=True)
    return m.eval()


def _oihw(k):
    return np.transpose(np.asarray(k), (3, 2, 0, 1))


def test_converter_loads_strict_and_names_every_parameter(variables):
    sd = jax_to_state_dict(variables)
    m = TLMNet(**TINY)
    missing, unexpected = m.load_state_dict(sd, strict=True)
    assert not missing and not unexpected
    assert set(sd) == set(m.state_dict())
    n_jax = sum(a.size for a in jax.tree_util.tree_leaves(variables["params"]))
    assert sum(p.numel() for p in m.parameters()) == n_jax
    # reference names, and layouts: HWIO -> OIHW, dense (in, out) -> (out, in)
    p = variables["params"]
    np.testing.assert_array_equal(
        sd["natt1.att1.qkv.weight"].numpy(), p["natt1"]["attn"]["qkv"]["dense"]["kernel"].T
    )
    np.testing.assert_array_equal(
        sd["gft.attention.qkv.weight"].numpy(), p["gft"]["attn"]["qkv"]["kernel"].T
    )
    np.testing.assert_array_equal(
        sd["conv1.0.large_conv.conv.weight"].numpy(),
        _oihw(p["conv1_0"]["large_conv"]["conv"]["kernel"]),
    )


def test_structural_reparam_matches_jax(port_model, jax_deploy):
    """Every fused 5x5 depthwise kernel and bias equals JAX's (fp32, rtol
    1e-6 / atol 1e-6: the same arithmetic, in another order)."""
    sd = t_structural_reparam(port_model.state_dict())
    p = jax_deploy["params"]
    names = [k for k in sd if k.endswith(".fuse_conv.weight")]
    assert len(names) == 16
    for k in names:
        block = k[: -len(".fuse_conv.weight")]
        jp = p[block.replace(".", "_")]["fuse_conv"]["conv"]
        np.testing.assert_allclose(sd[k].numpy(), _oihw(jp["kernel"]), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            sd[f"{block}.fuse_conv.bias"].numpy(), jp["bias"], rtol=1e-6, atol=1e-6
        )
    assert not any("_conv.bn." in k or ".large_conv." in k for k in sd)


@pytest.mark.parametrize("nat_backend", ["flat", "plain"])
def test_deploy_forward_matches_jax_fp32(port_model, jax_deploy, nat_backend):
    """The port's deploy graph == JAX deploy_forward(xla, xla) in fp32 at
    rtol 1e-4 / atol 1e-5 (tests/test_serve.py's tolerance)."""
    from lmnet_tpu.serve import deploy_forward

    x = np.random.RandomState(1).randn(2, HW, HW, 3).astype(np.float32)
    want = np.asarray(
        deploy_forward(jax_deploy, jnp.asarray(x), num_heads=HEADS,
                       nat_backend="xla", rc_backend="xla")
    )
    sd = t_structural_reparam(port_model.state_dict())
    with torch.no_grad():
        got = t_deploy_forward(sd, torch.from_numpy(x), num_heads=HEADS,
                               nat_backend=nat_backend).numpy()
    assert got.shape == (2, HW, HW, TINY["num_classes"]) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_eval_forward_equals_deploy_forward(port_model):
    """The train-graph eval forward before reparam == the deploy forward
    after it (fp32; fusing the branches reorders sums: rtol 1e-4 / atol
    1e-5)."""
    x = torch.from_numpy(np.random.RandomState(2).randn(2, HW, HW, 3).astype(np.float32))
    with torch.no_grad():
        ref = port_model(x)
        out = t_deploy_forward(t_structural_reparam(port_model.state_dict()), x,
                               num_heads=HEADS, nat_backend=("flat", "plain", "flat", "plain"))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-4, atol=1e-5)


def test_deploy_forward_rejects_unported_backends(port_model):
    sd = t_structural_reparam(port_model.state_dict())
    x = torch.zeros(1, 32, 32, 3)
    with pytest.raises(ValueError):
        t_deploy_forward(sd, x, num_heads=HEADS, rc_backend="pallas")
    with pytest.raises(ValueError):
        t_deploy_forward(sd, x, num_heads=HEADS, nat_backend=("flat",) * 3)


def test_serving_evaluate_bf16_matches_jax(variables, port_model, jax_deploy):
    """The served path in bf16 on both sides, over the same synthetic
    batches. bf16 rounds at other places in the two frameworks (XLA vs
    torch's float32 opmath), so the logits differ by bf16 noise (max 0.69 on
    logits of scale 17) and near-tied pixels flip. Measured on two seeds:
    loss gap 0.07% and 0.8%, metric gaps <= 0.005, argmax flips 0.7% and
    1.1% of the pixels. Bounds: loss 2% relative, every metric 0.02, flips
    under 2.5% of the pixels."""
    from lmnet_tpu.serve import deploy_forward
    from lmnet_tpu.serve.engine import serving_evaluate

    def loader():
        from lmnet_tpu.data.datasets import SyntheticDataset, make_loader

        return make_loader(SyntheticDataset(4, HW, "val", seed=3), 2)

    state = SimpleNamespace(params=variables["params"], batch_stats=variables["batch_stats"])
    j_loss, j_met = serving_evaluate(state, loader(), num_classes=2, img_size=HW,
                                     num_heads=HEADS)
    t_loss, t_met = t_serving_evaluate(
        port_model.state_dict(), t_make_loader(TSyntheticDataset(4, HW, "val", seed=3), 2),
        num_classes=2, img_size=HW, num_heads=HEADS,
    )
    assert np.isfinite(t_loss)
    assert abs(t_loss - j_loss) <= 0.02 * abs(j_loss), (t_loss, j_loss)
    assert set(t_met) == set(j_met)
    for k in j_met:
        assert abs(t_met[k] - j_met[k]) <= 0.02, (k, t_met[k], j_met[k])

    # per-pixel argmax agreement on one batch, both sides bf16
    from lmnet_tpu.data.augment import eval_pipeline

    images, masks = next(iter(loader()))
    xj, _ = eval_pipeline(jnp.asarray(images), jnp.asarray(masks), out_size=HW)
    lj = np.asarray(deploy_forward(jax_deploy, xj.astype(jnp.bfloat16), num_heads=HEADS,
                                   nat_backend="xla", rc_backend="xla"))
    sd = t_structural_reparam(port_model.state_dict())
    with torch.no_grad():
        lt = t_deploy_forward(sd, torch.from_numpy(np.array(xj)).to(torch.bfloat16),
                              num_heads=HEADS).numpy()
    flipped = np.mean(lj.argmax(-1) != lt.argmax(-1))
    assert flipped < 0.025, flipped
