"""The sharded train step on the card: two gloo ranks sharing one CUDA device
on a (1 x 2) ('data', 'spatial') mesh, each holding 32 rows of every 64^2
image and running ``tests/_torch_spatial_worker.py``'s 'card' case, against
one process on the same card.

The step is the full-width model's at float32, 64^2, a batch of 2, 'flat'
NAT (B1 and B2 on each rank's slabs of 33, 17, 9 and 5 rows),
``rc_remat=True``, dropout on: the halo exchanges of CUDA tensors through
gloo, and the kernels on slabs, which the CPU runs only as plain graphs.
Tolerances are the fp32 rule of the kernels' train step: loss rel 1e-5,
each gradient ||2 ranks - 1 process|| <= 1e-3 ||1 process|| + 1e-5
max||g||, the running statistics within 1e-4 |ref| + 1e-5 max|ref|, the
confusion matrix equal; B1 and B2 launch 4 times on each rank.

The row-window kernels B4-B7, in one process: each rank's slab of 2 and of
4 cut from a seeded whole map as the rank's exchange makes it (B5, B6: 2
rows of each neighbour, zero rows past the global edges; B4: 2 rows, none
past the edges; B7: 1 row, none past the edges), each kernel on it against
its plain windowed version by ``chip_smoke.py``'s checks (PERF.md's "a
kernel = its plain version" row), and against the same kernel on the
whole map: each rank's output rows (B4's phase 2 with the whole map's SE
scale) within 1e-6 max|ref| in float32 and one bf16 rounding in bf16, the
ranks' sums within 1e-5 of the sum of |t| (or |y|, y^2).

Imports no JAX: on the card it runs with
``python -m pytest --noconftest -m gpu tests/test_torch_spatial_card.py``.
Without a card it skips.
"""

import importlib.util
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from lmnet_tpu_torch.metrics import ConfusionAccumulator
from lmnet_tpu_torch.models import LMNet
from lmnet_tpu_torch.ops import _build
from lmnet_tpu_torch.train import create_train_state, train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_spatial_worker.py")
HW, B, SEED = 64, 2, 8


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.gpu
def test_two_gloo_ranks_on_h_blocks_match_one_process(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build("nat_fwd", "nat_bwd")  # once, before the ranks
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(B, HW, HW, 3).astype(np.float32))
    y = (x.mean(-1) > 0.1).long()
    torch.save({"x": x, "y": y}, tmp_path / "batch.pt")
    spec = dict(device="cuda", seed=SEED, n_spatial=2, batch=str(tmp_path / "batch.pt"),
                dir=str(tmp_path), cases=["card"])
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, WORKER, str(tmp_path / "spec.json")],
                                      env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            assert p.returncode == 0, out[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)["card"] for r in range(2)]

    for r in ranks:
        assert r["launches"] == {"nat_fwd": 4, "nat_bwd": 4}, r["launches"]
    assert all(torch.equal(ranks[0]["state"][k], ranks[1]["state"][k]) for k in ranks[0]["state"])
    dev = torch.device("cuda")
    model = LMNet(generator=torch.Generator().manual_seed(SEED), nat_backend="flat")
    state = create_train_state(model, tuple(x.shape), seed=SEED, device=dev)
    state, loss, cm = train_step(state, x.to(dev), y.to(dev), ConfusionAccumulator.init(2, dev))
    got, lo = ranks[0], float(loss)
    assert abs(got["loss"] - lo) <= 1e-5 * abs(lo), (got["loss"], lo)
    assert torch.equal(got["cm"], cm.cpu())
    go = {n: p.grad.cpu() for n, p in state.model.named_parameters()}
    big = max(v.norm().item() for v in go.values())
    for k, ref in go.items():
        err = (got["grads"][k] - ref).norm().item()
        assert err <= 1e-3 * ref.norm().item() + 1e-5 * big, (k, err)
    for k, ref in state.model.state_dict().items():
        if "running" in k:
            ref = ref.cpu()
            bound = 1e-4 * ref.abs() + 1e-5 * ref.abs().max().item()
            assert bool(((got["state"][k] - ref).abs() <= bound).all()), k


def _smoke():
    path = os.path.join(REPO, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_card", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _rows_close(got, want, what):
    big = want.float().abs().max().item()
    bound = (1e-6 * big if want.dtype == torch.float32
             else 2**-8 * want.float().abs() + 1e-6 * big)
    err = (got.float() - want.float()).abs()
    assert got.shape == want.shape and bool((err <= bound).all()), (what, err.max().item())


def _sums_close(got, want, scale, what):
    assert bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all()), \
        (what, (got - want).abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_window_kernels_on_slabs_match_plain_and_the_whole_map(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from test_torch_row_window import _slab

    from lmnet_tpu_torch.ops.rc_flat import dw_gelu_flat, se_scale
    from lmnet_tpu_torch.ops.rc_kernel import rc_phase1, rc_phase2
    from lmnet_tpu_torch.ops.rc_train import rc_branch_stats
    from lmnet_tpu_torch.ops.upsample_flat import _launch

    cs = _smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    B, H, W, Cin, E, Cout = 2, 64, 40, 12, 24, 12
    g = torch.Generator().manual_seed(13)
    e = torch.randn(B, H, W * E, generator=g).to(dev, dtype)
    k, b = (torch.randn(E, 1, 5, 5, generator=g) * 0.2).to(dev), torch.randn(E, generator=g).to(dev)
    ks = [(torch.randn(E, 1, kh, kw, generator=g) * 0.3).to(dev)
          for kh, kw in ((5, 5), (3, 3), (3, 1), (1, 3))]
    x = torch.randn(B, H, W, Cin, generator=g).to(dev, dtype)
    w = cs.rc_weights(14, Cin, E, Cout, dev)
    xu = torch.randn(B, 16, 20, 48, generator=g).to(dev, dtype)  # 'tma'
    xg = torch.randn(B, 16, 9, 12, generator=g).to(dev, dtype)  # 'generic' in bf16
    t, sums = dw_gelu_flat(e, k, b, E)
    stats = rc_branch_stats(e, *ks, E)
    s1 = rc_phase1(x, w)
    sc = se_scale(s1, w, H * W)
    y = rc_phase2(x, w, sc)
    ups = {name: (u, _launch(u)) for name, u in (("tma", xu), ("generic", xg))}
    t_scale = t.float().abs().reshape(B, H * W, E).sum(1)
    for size in (2, 4):
        got_sums, got_stats, got_s1 = 0, 0, 0
        for r in range(size):
            label = f"rank {r} of {size}"
            es, top, rows, _ = _slab(e, r, size, 2, edges=True)
            t_r, s_r = dw_gelu_flat(es, k, b, E, top, rows)
            cs.check_dw(f"B5 {label}", es, k, b, t_r, s_r, E, top, rows)
            _rows_close(t_r, t[:, r * rows:(r + 1) * rows], f"B5 t {label}")
            got_sums = got_sums + s_r
            st_r = rc_branch_stats(es, *ks, E, top, rows)
            cs.check_stats(f"B6 {label}", es, ks, st_r, E, top, rows)
            got_stats = got_stats + st_r
            xs, top, rows, _ = _slab(x, r, size, 2, edges=False)
            p1 = rc_phase1(xs, w, top, rows)
            got_s1 = got_s1 + p1
            cs.check_rc(f"B4 {label}", xs, w,
                        rc_phase2(xs, w, se_scale(p1, w, rows * W), top, rows), top, rows)
            _rows_close(rc_phase2(xs, w, sc, top, rows), y[:, r * rows:(r + 1) * rows],
                        f"B4 {label}")
            for name, (u, whole) in ups.items():
                us, top, rows, row0 = _slab(u, r, size, 1, edges=False)
                window = (top, rows, u.shape[1], row0)
                u_r = _launch(us, window)
                cs.check_up(f"B7 {name} {label}", u_r, us, window)
                _rows_close(u_r, whole[:, 2 * row0:2 * (row0 + rows)], f"B7 {name} {label}")
        _sums_close(got_sums, sums, t_scale, f"B5 sums over {size}")
        _sums_close(got_stats, stats, stats.abs().amax(-1, keepdim=True), f"B6 over {size}")
        _sums_close(got_s1, s1, s1.abs().amax(-1, keepdim=True), f"B4 phase 1 over {size}")
