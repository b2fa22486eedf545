"""The port's deploy artifact (``lmnet_tpu_torch/serve/export.py``) against
the JAX package, at TINY on the CPU.

The artifact is a ``torch.export`` program of ``deploy_forward`` with the
deploy state dict baked in and the plain backends pinned. Its logits at
batch 1, 3 and 8 (one symbolic-batch program) are held against JAX's
``deploy_forward(nat_backend='xla', rc_backend='xla')`` on the same weights
(float32, rtol 1e-4 / atol 1e-5, tests/test_serve.py's tolerance). The
module exports twice (the default and ``natt_int8``), each about 10 s here.
"""

import inspect
import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import TINY, TINY_HW
from test_torch_serve import jax_variables

from lmnet_tpu_torch.convert import jax_to_state_dict
from lmnet_tpu_torch.models import structural_reparam as t_structural_reparam
from lmnet_tpu_torch.ops import resize
from lmnet_tpu_torch.serve import export
from lmnet_tpu_torch.serve import deploy_forward as t_deploy_forward

HW = TINY_HW
HEADS = TINY["num_heads"]


@pytest.fixture(scope="module")
def variables():
    return jax_variables(0, HW)


@pytest.fixture(scope="module")
def deploy(variables):
    return t_structural_reparam(jax_to_state_dict(variables))


def _refuse(*_):
    raise AssertionError("the export traced the B7 kernel's wrapper")


@pytest.fixture(scope="module")
def blob(deploy):
    """The float32 artifact, exported with the upsample backend set to the
    B7 kernel ('flat', as ``LMNET_UPSAMPLE_BACKEND=flat`` sets it at import)
    and that kernel's wrapper replaced by one that raises: the export pins
    'einsum' and gives the setting back."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(resize, "UPSAMPLE_BACKEND", "flat")
        mp.setattr(resize, "upsample2x_flat", _refuse)
        program = export.export_deploy(deploy, img_size=HW, num_heads=HEADS,
                                       dtype=torch.float32, device="cpu")
        assert resize.UPSAMPLE_BACKEND == "flat"
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


@pytest.fixture(scope="module")
def loaded(blob):
    return export.load_deploy(blob, device="cpu")


def _x(b, seed=1):
    return np.random.RandomState(seed + b).randn(b, HW, HW, 3).astype(np.float32)


def test_artifact_matches_jax_deploy_forward_at_any_batch(variables, loaded):
    """One symbolic-batch artifact, loaded on the CPU, gives JAX's logits at
    batch 1, 3 and 8; it takes the dtype it was exported with."""
    from lmnet_tpu.models import structural_reparam
    from lmnet_tpu.serve import deploy_forward

    jax_deploy = jax.device_get(structural_reparam(variables))
    assert export.input_dtype(loaded) == torch.float32
    for b in (1, 3, 8):
        x = _x(b)
        want = np.asarray(deploy_forward(jax_deploy, jnp.asarray(x), num_heads=HEADS,
                                         nat_backend="xla", rc_backend="xla"))
        with torch.inference_mode():
            got = loaded(torch.from_numpy(x))
        assert got.shape == (b, HW, HW, TINY["num_classes"]) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5, err_msg=f"batch {b}")


def test_natt_int8_artifact_matches_the_eager_engine(deploy):
    """``natt_int8`` traces (its int8 products are float32 ``F.linear``) and
    the artifact gives the eager ``deploy_forward(natt_int8=True)``'s
    logits (rtol 1e-4 / atol 1e-5)."""
    fn = export.export_deploy(deploy, img_size=HW, num_heads=HEADS, dtype=torch.float32,
                              natt_int8=True).module()
    x = torch.from_numpy(_x(3))
    with torch.inference_mode():
        got = fn(x)
        want = t_deploy_forward(deploy, x, num_heads=HEADS, nat_backend="plain", natt_int8=True)
        plain = t_deploy_forward(deploy, x, num_heads=HEADS, nat_backend="plain")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-5)
    assert (want - plain).abs().max() > 1e-4  # the int8 interiors are really on


def test_save_and_load_file_round_trip(deploy, loaded, tmp_path):
    """``save_deploy`` writes a file that ``load_deploy_file`` serves on the
    CPU with the blob's logits; both loaders default to the card."""
    path = export.save_deploy(str(tmp_path / "lmnet.pt2"), deploy, img_size=HW,
                              num_heads=HEADS, dtype=torch.float32)
    assert path == str(tmp_path / "lmnet.pt2")
    x = torch.from_numpy(_x(2))
    with torch.inference_mode():
        got = export.load_deploy_file(path, device="cpu")(x)
        want = loaded(x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for fn in (export.load_deploy, export.load_deploy_file):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
