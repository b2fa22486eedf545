"""SegFormer through the architecture slot (``arch/segformer.py``): its
state dict loads into the port's model, its operation count reproduces the
published 183.3 GMAC of SegFormer-B5 at 640^2, the train window and its
checks run at small widths on the CPU (``correct``, and false under each
fault), and the five readers of this architecture give None on a trace
without its spans, attention or BatchNorm kernels and exact numbers on a
trace written by hand."""

from __future__ import annotations

import json
import time

import pytest
import torch

import arch
import run as runner
from conftest import BENCH
from lmbench import cells, profile, readers

CONFIG = json.loads((BENCH / "configs" / "segformer-b5-1024.json").read_text())
SMALL = {"num_classes": 5, "embed_dims": [8, 16, 24, 32], "num_heads": [1, 2, 3, 4],
         "depths": [1, 1, 2, 1], "sr_ratios": [8, 4, 2, 1], "mlp_ratio": 4, "decoder_dim": 16,
         "drop_path": 0.1, "dropout": 0.1}
READERS = ("mit_attn_share.train", "mit_ffn_share.train", "segformer_head_share.train",
           "sdpa_roofline.train", "head_bn_roofline.train")


def _small(size=64):
    return dict(CONFIG, model=SMALL, image_size=size)


def test_the_configuration_is_segformer_b5_at_1024():
    assert arch.name(CONFIG) == "segformer" and arch.load(CONFIG).__name__ == "arch.segformer"
    m = CONFIG["model"]
    assert (m["embed_dims"], m["num_heads"], m["depths"], m["sr_ratios"]) == (
        [64, 128, 320, 512], [1, 2, 5, 8], [3, 6, 40, 3], [8, 4, 2, 1])
    assert (m["mlp_ratio"], m["decoder_dim"], m["num_classes"]) == (4, 768, 19)
    assert (CONFIG["image_size"], CONFIG["dtype"], CONFIG["reduced"]) == (1024, "bfloat16", [])


def test_param_specs_load_into_the_model_strictly():
    """The drawn weights load with ``strict=True`` at small widths; at
    MiT-B5 the names and shapes are the model's (on meta tensors) and count
    the configuration's ``parameters``."""
    A = arch.load(CONFIG)
    model = A.train_model(_small(), {"model": {}})
    model.load_state_dict(arch.weights(_small(), 3, "cpu"), strict=True)
    with torch.device("meta"):
        full = A.train_model(CONFIG, {"model": {}})
    specs = A.param_specs(CONFIG)
    assert {k: tuple(v.shape) for k, v in full.state_dict().items()} == {
        n: tuple(s) for n, s, _, _ in specs}
    trained = sum(int(torch.Size(s).numel()) for n, s, _, _ in specs if "running_" not in n)
    assert trained == CONFIG["parameters"]


def test_forward_flops_reproduce_the_published_gmac_at_640():
    """mmseg's 183.3 G (multiply-adds) for SegFormer-B5 at 640^2 with 150
    classes, within 0.5 %; at 1024^2 and 19 classes 561.05 GMAC, of it the
    attention's products 162.14 (``attention_flops``, by the formula)."""
    A = arch.load(CONFIG)
    ade = dict(CONFIG, image_size=640, model=dict(CONFIG["model"], num_classes=150))
    assert A.forward_flops(ade, False) / 2 == pytest.approx(183.3e9, rel=5e-3)
    assert A.forward_flops(CONFIG, True) / 2 == pytest.approx(561.05e9, rel=1e-4)
    sides, reduced = (256, 128, 64, 32), (32, 32, 32, 32)
    by_hand = sum(4 * d * (s * s) * (r * r) * c for d, s, r, c in zip(
        (3, 6, 40, 3), sides, reduced, (64, 128, 320, 512)))
    assert A.attention_flops(CONFIG) == by_hand == pytest.approx(2 * 162.135e9, rel=1e-5)


def _run(cell, faults=None, seed=2**31 + 21):
    return cells.Run(cell["name"], cell["config"], cell["traffic"], cell["limits"], seed, 0.3,
                     False, torch.device("cpu"), time.perf_counter(), faults or {})


@pytest.fixture
def small_cell():
    cell = runner.load_cell("segformer-b5-1024.train-b8")
    cell["config"] = dict(_small(), dtype="float32")
    cell["traffic"] = dict(cell["traffic"], batch=4, trace_seconds=0.1)
    # float32 on both sides here: sound runs read ~1e-6, the faults >= 1e-3
    cell["limits"] = {"loss": 1e-4, "grad1": 1e-4, "change": 1e-3, "bn_stats": 1e-3}
    return cell


def test_train_window_is_correct_and_each_fault_fails(small_cell):
    from lmnet_tpu_torch.train import train_step

    def unchanged(state, images, labels, cm, **kw):
        return state, state.model(images).float().mean().detach(), cm

    def half(state, images, labels, cm, **kw):
        n = images.shape[0] // 2
        return train_step(state, images[:n], labels[:n], cm, **kw)

    res = cells.train(_run(small_cell))
    assert runner.verdict(res), res.numbers
    assert set(res.e2e) == {"train_img_s", "setup_s"}
    for fault in (unchanged, half):
        res = cells.train(_run(small_cell, {"train_step": fault}))
        assert not runner.verdict(res), (fault.__name__, res.numbers)


def test_serving_is_the_eval_forward_and_a_fault_fails(small_cell):
    config = small_cell["config"]
    raw = arch.weights(config, 5, "cpu")
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(6))
    A = arch.load(config)
    with torch.no_grad():
        got = A.serve_fn(config, {}, raw, {})(x)
        want = A.reference(config, raw).forward(x)
    assert float((got - want).norm() / want.norm()) < 1e-5
    seen = []
    A.serve_fn(config, {}, raw, {"segformer_forward": lambda mod, x: seen.append(x)})(x)
    assert len(seen) == 1
    with pytest.raises(TypeError):
        A.serve_fn(config, {"deploy": {"rc_backend": "xla"}}, raw, {})


# -- the readers --------------------------------------------------------------------------


def _ev(name, ts, dur, tid=1, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}


def _launch(ts, corr, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "tid": tid, "args": {"correlation": corr}}


def _kernel(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _ctx(events, images=16, untraced=8, batch=8):
    return readers.Context(CONFIG, {"images": images, "untraced": (untraced, 1.0),
                                    "batch": batch}, trace=profile.from_events(events))


def _window():
    return [_ev(profile.WINDOW, 0, 1000)]


def test_readers_give_none_without_segformer_spans_or_sdpa():
    """LM-Net's spans and plain ops: nothing of this architecture to read."""
    events = _window() + [
        _ev("lmnet.step.forward", 10, 100), _ev("aten::linear", 20, 10, cat="cpu_op"),
        _launch(21, 1), _kernel("sm90_gemm", 30, 40, 1)]
    for name in READERS:
        assert runner.metric_reader(name).read(_ctx(events)) is None, name
        assert runner.metric_reader(name).read(readers.Context(CONFIG, {})) is None, name


def test_readers_read_a_hand_written_trace():
    """Busy 400 us: an attention span's kernels 100 us (the flash forward 60
    of it), a Mix-FFN's 80, the head's 20, the flash backward on the
    autograd thread 150, a kernel under no span 50. One traced step of 8
    images."""
    events = _window() + [
        _ev("segformer.attn", 10, 100),
        _ev("aten::scaled_dot_product_attention", 20, 20, cat="cpu_op"),
        _ev("aten::_scaled_dot_product_flash_attention", 21, 15, cat="cpu_op"),
        _launch(22, 1), _launch(50, 2),
        _ev("segformer.ffn", 120, 50), _launch(130, 3),
        _ev("segformer.head", 180, 10), _launch(182, 4),
        _ev("aten::_scaled_dot_product_flash_attention_backward", 200, 30, tid=2, cat="cpu_op"),
        _launch(205, 5, tid=2), _launch(240, 6),
        _kernel("pytorch_flash::flash_fwd_kernel", 100, 60, 1),
        _kernel("gemm", 160, 40, 2),
        _kernel("dwconv", 200, 80, 3), _kernel("elementwise_kernel", 280, 20, 4),
        _kernel("pytorch_flash::flash_bwd_dq_dk_dv_kernel", 300, 150, 5),
        _kernel("adam", 450, 50, 6)]
    ctx = _ctx(events)
    read = {name: runner.metric_reader(name).read(ctx) for name in READERS}
    assert read["mit_attn_share.train"] == pytest.approx(25.0)
    assert read["mit_ffn_share.train"] == pytest.approx(20.0)
    assert read["segformer_head_share.train"] == pytest.approx(5.0)
    flops = 3 * arch.load(CONFIG).attention_flops(CONFIG) * 8
    assert read["sdpa_roofline.train"] == pytest.approx(100 * flops / 989e12 / 210e-6)


def test_head_bn_roofline_reads_the_bn_train_kernels():
    """One traced step of 8 images whose head BatchNorm kernels take 600 us
    of device time: the step's 768 x 256^2 bf16 elements an image, read
    and written five times in all, at 3.35 TB/s over those 600 us."""
    events = _window() + [
        _launch(10, 1), _launch(20, 2), _launch(30, 3),
        _kernel("bn_train_stats_kernel", 100, 200, 1), _kernel("gemm", 300, 200, 2),
        _kernel("bn_train_bwd_apply_kernel", 500, 400, 3)]
    got = runner.metric_reader("head_bn_roofline.train").read(_ctx(events))
    assert arch.load(CONFIG).bn_elements(CONFIG) == 256 * 256 * 768
    assert got == pytest.approx(100 * 8 * 5 * 2 * 256 * 256 * 768 / 3.35e12 / 600e-6)
