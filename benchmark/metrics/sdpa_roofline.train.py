"""The SDPA kernels' share of their roofline in the traced window: the
attention's model operations a step (``arch/segformer.py::attention_flops``:
4 N M C a block an image forward, x 3 for the forward and backward, no
recompute counted, as ``mfu.train`` counts) at the bf16 tensor-core peak,
times the traced steps, over the device time of the flash and
memory-efficient attention kernels, forward and backward
(``pytorch_flash::flash_fwd*``, ``flash_bwd*``, ``fmha_cutlassF*``,
``fmha_cutlassB*``), matched by name: the train step replays them from CUDA
graphs, where no SDPA op runs on the host. None where no such kernel ran."""

from lmbench import arith, readers

LAYER = "flash and memory-efficient SDPA kernels: models/segformer.py::attention"
UNIT = "%"
MOVES = "train_img_s"
SOURCE = "device_trace"
KERNELS = ("flash_fwd", "flash_bwd", "fmha_cutlass")


def read(ctx):
    if ctx.trace is None:
        return None
    import arch

    flops = 3 * arch.load(ctx.config).attention_flops(ctx.config)
    return readers.roofline(ctx, KERNELS, lambda batch: batch * flops / arith.TC_RATE)
