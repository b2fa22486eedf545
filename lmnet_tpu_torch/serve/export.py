"""Serialized serving artifacts: the re-parameterized LM-Net deploy graph
exported with ``torch.export``.

Counterpart of ``lmnet_tpu/serve/export.py``. The deploy forward is traced
once with the deploy state dict baked in as the program's buffers and
written to one file; the serving process needs torch and that file, no
model code and no checkpoint format.

The export pins the plain formulations, as JAX pins ``nat_backend='xla',
rc_backend='xla'``: NAT 'plain', ReparamConv 'xla' and the 'einsum'
upsample, whatever ``LMNET_UPSAMPLE_BACKEND`` says. The kernels stay a
run-time choice of the live engine (``deploy_forward``). JAX's artifact is
multi-platform; here a program records the device it was traced on, so
``load_deploy`` moves it (``torch.export.passes.move_to_device_pass``) when
it is loaded onto another: an artifact written on the CPU serves on the
card, and one written on the card loads on the CPU.

The batch dimension is exported symbolically by default, so one artifact
serves any batch size; height and width are static, as in JAX.
"""

from __future__ import annotations

import io
from collections.abc import Mapping

import torch

from lmnet_tpu_torch.ops import resize
from lmnet_tpu_torch.serve.engine import deploy_forward


class _DeployModule(torch.nn.Module):
    """``deploy_forward`` over the deploy state dict held as buffers, with
    the plain backends pinned."""

    def __init__(self, variables: Mapping[str, torch.Tensor], num_heads: int,
                 natt_int8: bool):
        super().__init__()
        self.names = list(variables)
        for name in self.names:
            # a snapshot: structural_reparam passes most entries through as
            # the live model's own tensors
            self.register_buffer(name.replace(".", "__"), variables[name].detach().clone())
        self.num_heads = num_heads
        self.natt_int8 = natt_int8

    def forward(self, x):
        sd = {name: getattr(self, name.replace(".", "__")) for name in self.names}
        return deploy_forward(sd, x, num_heads=self.num_heads, nat_backend="plain",
                              rc_backend="xla", natt_int8=self.natt_int8)


def export_deploy(
    variables: Mapping[str, torch.Tensor],
    img_size: int = 256,
    num_heads: int = 12,
    batch: int | None = None,
    dtype: torch.dtype = torch.bfloat16,
    natt_int8: bool = False,
    device: torch.device | str | None = None,
) -> torch.export.ExportedProgram:
    """Export the deploy forward for ``variables`` (a ``structural_reparam``
    output) to an ``ExportedProgram`` taking NHWC ``(batch, img_size,
    img_size, 3)`` inputs of ``dtype``.

    ``batch=None`` exports a symbolic batch dimension (any batch size at
    run time); an int pins it. ``device``: where the program is traced and
    its buffers live; by default the variables' device.
    """
    if device is None:
        device = next(iter(variables.values())).device
    module = _DeployModule({k: v.to(device) for k, v in variables.items()}, num_heads, natt_int8)
    example = torch.zeros(2 if batch is None else batch, img_size, img_size, 3, dtype=dtype,
                          device=device)
    shapes = {"x": {0: torch.export.Dim("batch", min=1)}} if batch is None else None
    pinned = resize.UPSAMPLE_BACKEND
    resize.UPSAMPLE_BACKEND = "einsum"
    try:
        return torch.export.export(module, (example,), dynamic_shapes=shapes)
    finally:
        resize.UPSAMPLE_BACKEND = pinned


def save_deploy(path: str, variables: Mapping[str, torch.Tensor], **kw) -> str:
    """Export (``export_deploy(variables, **kw)``) and write the artifact to
    ``path``; returns the path."""
    torch.export.save(export_deploy(variables, **kw), path)
    return path


def _program_device(program: torch.export.ExportedProgram) -> torch.device:
    return next(iter(program.state_dict.values())).device


def load_deploy(blob: bytes, device: torch.device | str = "cuda"):
    """Deserialize a ``save_deploy`` artifact into a callable ``fn(x) ->
    logits`` on ``device`` (the card unless the caller asks for the CPU),
    moved there when it was exported on another device."""
    return _on_device(torch.export.load(io.BytesIO(blob)), device)


def load_deploy_file(path: str, device: torch.device | str = "cuda"):
    """``load_deploy`` of the file at ``path``."""
    return _on_device(torch.export.load(path), device)


def input_dtype(fn) -> torch.dtype:
    """The dtype of the images a loaded artifact takes (the ``dtype`` it was
    exported with)."""
    (x,) = (n for n in fn.graph.nodes if n.op == "placeholder")
    return x.meta["val"].dtype


def _on_device(program: torch.export.ExportedProgram, device):
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if _program_device(program) != device:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, device)
    return program.module()
