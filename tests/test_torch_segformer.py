"""SegFormer in the port (``models/segformer.py``) against the plain float32
reference the benchmark holds it to (``benchmark/reference/segformer.py``),
on seeded weights at small widths on the CPU: the eval logits, the
train-mode forward with its drop-path and Dropout2d masks, and one
``train_step`` (loss, gradients, BatchNorm running statistics); its spans;
the CLI's ``--arch segformer-b5``. Beside it, the repairs of
``models/blocks.py`` it needed: ``LayerNorm``'s ``eps``, ``conv_nhwc``'s
``padding`` (LM-Net's results bitwise as before), and the BatchNorm kernels'
check at the head's width and beyond what they take.
"""

from __future__ import annotations

import contextlib
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from lmbench import inputs  # noqa: E402
from reference import segformer as ref  # noqa: E402
from reference import train as recipe  # noqa: E402

from lmnet_tpu_torch.metrics import ConfusionAccumulator  # noqa: E402
from lmnet_tpu_torch.models import LMNet, SegFormer, blocks  # noqa: E402
from lmnet_tpu_torch.models import segformer as seg  # noqa: E402
from lmnet_tpu_torch.ops import bn_train  # noqa: E402
from lmnet_tpu_torch.ops.layer_norm import _stats  # noqa: E402
from lmnet_tpu_torch.train import create_train_state, train_step  # noqa: E402

# the tiny widths: every stage's kind of block (sr 8/4/2/1), head_dim 8
SMALL = {"num_classes": 5, "embed_dims": [8, 16, 24, 32], "num_heads": [1, 2, 3, 4],
         "depths": [1, 1, 2, 1], "sr_ratios": [8, 4, 2, 1], "mlp_ratio": 4, "decoder_dim": 16,
         "drop_path": 0.1, "dropout": 0.1}
HW, B = 64, 2


def _model(m=SMALL, **kw) -> SegFormer:
    return SegFormer(**m, **kw)


def _weights(seed=3) -> dict:
    return inputs.weights(ref.param_specs(SMALL), seed, "cpu")


def _batch(seed=4):
    return inputs.images_and_masks(B, HW, inputs.generator(seed, "cpu"), "cpu",
                                   classes=SMALL["num_classes"])


def _loaded(raw) -> SegFormer:
    model = _model()
    model.load_state_dict(raw, strict=True)
    return model


def _rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def test_state_dict_is_the_references_and_nvlabs_names():
    got = {k: tuple(v.shape) for k, v in _model().state_dict().items()}
    want = {name: shape for name, shape, _, _ in ref.param_specs(SMALL)}
    assert got == want
    for name in ("patch_embed1.proj.weight", "block3.1.attn.sr.weight",
                 "block1.0.mlp.dwconv.dwconv.bias", "norm4.weight", "linear_c1.proj.weight",
                 "linear_fuse.conv.weight", "linear_fuse.bn.running_var", "linear_pred.bias"):
        assert name in got, name
    assert "block4.0.attn.sr.weight" not in got  # sr 1: keys and values from x


def test_mit_b5_counts_84_6_million_parameters():
    with torch.device("meta"):
        model = SegFormer()
    assert sum(p.numel() for p in model.parameters()) == 84_607_955
    assert [len(getattr(model, f"block{i}")) for i in range(1, 5)] == [3, 6, 40, 3]


def test_eval_logits_equal_the_reference():
    """float32 both: SDPA against the written-out softmax, the port's
    LayerNorm (E[x^2] - E[x]^2) against ``F.layer_norm``: within 1e-5 of
    the logits' norm."""
    raw = _weights()
    x, _ = _batch()
    with torch.no_grad():
        got = _loaded(raw)(x)
        want = ref.SegFormerRef(raw, SMALL).forward(x)
    assert got.shape == (B, HW, HW, SMALL["num_classes"]) and got.dtype == torch.float32
    assert _rel(got, want) < 1e-5


def test_train_forward_draws_the_references_masks():
    """The train-mode forward with drop path and Dropout2d, their masks from
    one seed on both sides, and the BatchNorm's batch statistics; the
    generators end in one place. Without the masks the logits differ."""
    raw = _weights()
    x, _ = _batch()
    model = _loaded(raw)
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        got = model(x, train=True, generator=g)
    r = ref.SegFormerRef(raw, SMALL)
    g_ref = torch.Generator().manual_seed(11)
    with torch.no_grad():
        want = r.forward(x, True, ref.draw_masks(B, SMALL, g_ref, "cpu"))
        plain = ref.SegFormerRef(raw, SMALL).forward(x, True)
    assert _rel(got, want) < 1e-5
    assert _rel(got, plain) > 1e-3
    assert torch.equal(torch.rand(4, generator=g), torch.rand(4, generator=g_ref))
    (_, mean, var), = r.stats
    bn = model.linear_fuse.bn
    m = recipe.BN_MOMENTUM
    assert torch.allclose(bn.running_mean, (1 - m) * raw["linear_fuse.bn.running_mean"]
                          + m * mean, rtol=0, atol=1e-5)
    assert torch.allclose(bn.running_var, (1 - m) * raw["linear_fuse.bn.running_var"]
                          + m * var, rtol=0, atol=1e-5)


def test_one_train_step_equals_the_references():
    """``train_step`` with ``num_classes=5`` (uniform weights) against the
    reference's step (``reference/train.py``, its masks from the same
    seed): loss within 1e-5, every gradient within 1e-4 of its leaf's norm
    (1e-3 of the median leaf's for a leaf that is round-off, a key's bias),
    the running statistics within 1e-5."""
    raw = _weights()
    x, y = _batch()
    model = _loaded(raw)
    state = create_train_state(model, (B, HW, HW, 3), seed=7, device="cpu")
    _, loss, _ = train_step(state, x, y, ConfusionAccumulator.init(5, "cpu"), num_classes=5)
    losses, grads, after = ref.train_steps(raw, [(x, y)], torch.Generator().manual_seed(7),
                                           SMALL)
    assert abs(float(loss) - losses[0]) <= 1e-5 * abs(losses[0])
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(grads)
    med = float(torch.tensor([float(g.norm()) for g in grads.values()]).median())
    for k, g in grads.items():
        assert float((got[k] - g).norm()) <= max(1e-4 * float(g.norm()), 1e-3 * med), k
    for k in ("running_mean", "running_var"):
        name = f"linear_fuse.bn.{k}"
        assert torch.allclose(model.state_dict()[name], after[name], rtol=0, atol=1e-5)


def test_each_span_opens_as_often_as_stated(monkeypatch):
    """At MiT-B5's depths (3/6/40/3; the small widths): ``segformer.embed``
    4 times a forward, ``segformer.attn`` and ``segformer.ffn`` 52 each,
    ``segformer.head`` once, in train mode as in eval."""
    opened = []

    def span(name):
        opened.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(seg, "span", span)
    model = _model(dict(SMALL, depths=[3, 6, 40, 3]))
    x, _ = _batch()
    for train in (False, True):
        opened.clear()
        with torch.no_grad():
            model(x, train=train, generator=torch.Generator().manual_seed(1))
        counts = {n: opened.count(n) for n in set(opened)}
        assert counts == {"segformer.embed": 4, "segformer.attn": 52, "segformer.ffn": 52,
                          "segformer.head": 1}, (train, counts)


# -- the repairs of models/blocks.py --------------------------------------------------------


def _old_layer_norm(self, x):
    """``LayerNorm.forward`` before ``eps`` was a field: the module's LN_EPS."""
    mean, var = _stats(x, -1)
    y = (x - mean[..., None]) * (torch.rsqrt(var + blocks.LN_EPS)[..., None] * self.weight)
    return (y + self.bias).to(x.dtype)


def _old_conv_nhwc(x, weight, bias=None, stride=1, groups=1, slab=0, padding=None):
    """``conv_nhwc`` before ``padding``: k//2 on both axes, always."""
    assert padding is None
    kh, kw = weight.shape[2], weight.shape[3]
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype),
                 None if bias is None else bias.to(x.dtype), stride, (kh // 2, kw // 2), 1, groups)
    return y.permute(0, 2, 3, 1)


@pytest.mark.parametrize("train", [False, True])
def test_lmnet_is_bitwise_what_it_was_before_eps_and_padding(monkeypatch, train):
    """LM-Net's logits, train-mode (dropout on) and eval, equal bitwise those
    of the blocks' former LayerNorm and conv_nhwc at TINY widths."""
    def run():
        model = LMNet(num_classes=2, filters=(4, 8, 12, 16, 24), num_heads=2,
                      nat_backend="plain")
        x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(5))
        with torch.no_grad():
            return model(x, train=train, generator=torch.Generator().manual_seed(6))

    now = run()
    assert all(m.eps == 1e-5 for m in LMNet().modules() if isinstance(m, blocks.LayerNorm))
    monkeypatch.setattr(blocks.LayerNorm, "forward", _old_layer_norm)
    monkeypatch.setattr(blocks, "conv_nhwc", _old_conv_nhwc)
    assert torch.equal(now, run())


def test_conv_padding_zero_is_the_strided_patch_conv():
    x = torch.randn(2, 8, 12, 5)
    w = torch.randn(6, 5, 4, 4)
    got = blocks.conv_nhwc(x, w, None, 4, padding=0)
    want = F.conv2d(x.permute(0, 3, 1, 2), w, stride=4).permute(0, 2, 3, 1)
    assert got.shape == (2, 2, 3, 6) and torch.equal(got, want)


@pytest.mark.parametrize("C,takes", [(768, True), (1024, True), (1536, False), (257, False),
                                     (256, True)])
def test_bn_train_takes_the_heads_width_and_refuses_what_it_cannot(C, takes):
    """The kernels' check passes SegFormer's head (768 channels, bf16) and
    refuses what the kernels cannot take (over 1024 channels, an odd bf16
    width above 256): the card raises rather than give way to another
    composition. ``BatchNorm.train_forward`` on the CPU is the plain
    composition at every width."""
    x = torch.randn(2, 3, 4, C).to(torch.bfloat16)
    w = torch.ones(C)
    if takes:
        bn_train._check(x, w)
    else:
        with pytest.raises(ValueError):
            bn_train._check(x, w)
    bn = blocks.BatchNorm(C)
    y, mean, var = bn.train_forward(x)
    wy, wmean, wvar = bn_train.batch_norm_train_plain(x, bn.weight, bn.bias)
    assert torch.equal(y, wy) and torch.equal(mean, wmean) and torch.equal(var, wvar)


# -- the CLI ---------------------------------------------------------------------------------


def test_cli_trains_segformer_b5_one_step(tmp_path, capsys):
    """``--arch segformer-b5`` at 64^2: one step of B=8 (the synthetic set's
    8 training images), one evaluation, the CSV row and the checkpoints; and
    the deploy-graph modes refuse it."""
    from lmnet_tpu_torch.cli import train as cli

    argv = ["--arch", "segformer-b5", "--synthetic", "--k_fold", "False", "--epochs", "1",
            "--batch_size", "8", "--img_size", "64", "--num_classes", "2", "--device", "cpu",
            "--num_workers", "1", "--ckpt_dir", str(tmp_path / "ckpt"),
            "--out_dir", str(tmp_path / "out")]
    assert cli.build_parser().parse_args([]).arch == "lmnet"
    assert isinstance(cli.build_model(cli.build_parser().parse_args(argv)), SegFormer)
    cli.main(argv)
    rows = (tmp_path / "out" / "LM_NetKvasir_0.csv").read_text().strip().splitlines()
    assert len(rows) == 1 and len(rows[0].split(",")) == 16
    assert "train_loss:" in capsys.readouterr().out
    for extra in (["--export", str(tmp_path / "a.pt2")], ["--test", "--serve"]):
        with pytest.raises(SystemExit, match="deploy graph"):
            cli.main(argv + extra)


# -- the card --------------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1536, 257])
def test_batchnorm_refuses_widths_the_kernels_refuse_on_the_card(cuda, C):
    """bf16 at C = 1536 (over MAX_C) and 257 (an odd width above 256): the
    train-mode forward raises on the card; no other composition runs in
    the kernels' place."""
    bn = blocks.BatchNorm(C).to(cuda)
    x = torch.randn(2, 5, 7, C, device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError):
        bn.train_forward(x)


@pytest.mark.gpu
def test_segformer_attention_runs_flash_or_efficient_sdpa_on_the_card(cuda):
    """bf16 at head_dim 64 on the card: the restricted SDPA runs (no math
    fall-back) and agrees with the written-out float32 softmax within bf16
    rounding."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(2, 2, n, 64, generator=g, device=cuda) for n in (4096, 256, 256))
    got = seg.attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    want = torch.softmax(q @ k.transpose(-1, -2) / 8.0, dim=-1) @ v
    assert _rel(got, want) < 2e-2


@pytest.mark.gpu
def test_train_steps_on_the_card_run_as_cuda_graphs_and_equal_the_reference(cuda):
    """float32 at the small widths (TF32 off): three ``train_step`` calls,
    whose train-mode forward runs as CUDA graphs captured at the first,
    against the reference's three steps from the same weights and
    generator seed: losses within 1e-4 (steps 2 and 3 after the graphed
    updates), the first gradients within 1e-3 of their leaf's norm (1e-2 of
    the median leaf's), the running statistics within 1e-4; the generators
    end in one place."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    raw = {k: v.to(cuda) for k, v in _weights().items()}
    batches = [tuple(t.to(cuda) for t in _batch(seed)) for seed in (4, 5, 6)]
    model = _loaded(raw)
    state = create_train_state(model, (B, HW, HW, 3), seed=7, device=cuda)
    cm = ConfusionAccumulator.init(5, cuda)
    losses, grads = [], None
    for x, y in batches:
        _, loss, _ = train_step(state, x, y, cm, num_classes=5)
        losses.append(float(loss))
        if grads is None:
            grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    assert model._graphs is not None and model._graphs[0][0] == (B, HW, HW, 3)
    g_ref = torch.Generator(device=cuda).manual_seed(7)
    want, wgrads, after = ref.train_steps(raw, batches, g_ref, SMALL)
    for a, b in zip(losses, want):
        assert abs(a - b) <= 1e-4 * abs(b), (losses, want)
    med = float(torch.tensor([float(g.norm()) for g in wgrads.values()]).median())
    for k, g in wgrads.items():
        assert float((grads[k] - g).norm()) <= max(1e-3 * float(g.norm()), 1e-2 * med), k
    for k in ("running_mean", "running_var"):
        name = f"linear_fuse.bn.{k}"
        assert torch.allclose(model.state_dict()[name], after[name], rtol=0, atol=1e-4)
    assert torch.equal(torch.rand(4, generator=state.generator, device=cuda),
                       torch.rand(4, generator=g_ref, device=cuda))


@pytest.mark.gpu
def test_graphed_forward_refuses_a_replay_before_its_backward_and_follows_new_storage(cuda):
    """The train-mode forward's CUDA graphs: a second forward while the
    first one's backward is pending raises (it would overwrite what that
    backward reads); once the backward ran, or the graph was freed, it
    replays the same graphs; a parameter re-assigned is captured anew, and
    its gradient reaches the new parameter; a move of the module drops the
    graphs."""
    model = _loaded({k: v.to(cuda) for k, v in _weights().items()}).to(cuda)
    x = _batch()[0].to(cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    out = model(x, train=True, generator=g)
    key = model._graphs[0]
    with pytest.raises(RuntimeError, match="before the backward"):
        model(x, train=True, generator=g)
    out.square().mean().backward()
    out = model(x, train=True, generator=g)
    del out  # its graph freed without a backward
    out = model(x, train=True, generator=g)
    assert model._graphs[0] == key
    out.square().mean().backward()
    model.linear_pred.weight = torch.nn.Parameter(model.linear_pred.weight.detach().clone())
    model(x, train=True, generator=g).square().mean().backward()
    assert model._graphs[0][:3] == key[:3] and model._graphs[0] != key
    assert model.linear_pred.weight.grad is not None
    model.to(cuda, torch.float64)
    assert model._graphs is None
