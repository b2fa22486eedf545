"""The three kinds of traffic a cell runs, each a window over the port's
public entry points, and its check against the reference afterwards. The
model, its weights and its reference come from the configuration's
architecture (``arch/__init__.py``).

* ``serve``: chains of ``chain`` batches through the architecture's serving
  callable on the run's weights, each batch's logits summed on the device,
  one host read a chain; the rate is every image of the window over the
  window's seconds. Two rows of every batch (one in each half, drawn from
  the seed) are kept, and a seeded sample of those batches, the last among
  them, is held against the reference.
* ``train``: ``train.train_step`` on a ``create_train_state`` of the
  architecture's train-mode module with the run's weights, one host read of
  the loss a step. Set-up drives the same state through the first
  ``check_steps`` steps on distinct batches of the pool; the reference
  follows those. The window continues with that state.
* ``open_loop``: ``serve.daemon.DynamicBatcher`` around the serving
  callable, requests sent on ``openloop.schedule``'s times; every answered
  request's masks are held against the reference.

Each returns a ``Result``; ``run.py`` prints it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

import arch
from lmbench import check, inputs, openloop
from lmbench.profile import Tracer, warm


@dataclass
class Run:
    """What a cell's run is given."""

    cell: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float  # time.perf_counter() at the process's start
    faults: dict = field(default_factory=dict)  # test hooks: name -> callable


@dataclass
class Result:
    e2e: dict = field(default_factory=dict)  # name -> value
    attempted: int = 0
    failed: int = 0
    numbers: dict = field(default_factory=dict)  # compared name -> (value, limit, note)
    memory_peak: int = 0
    window: dict = field(default_factory=dict)  # what the per-layer readers need
    counters: dict = field(default_factory=dict)
    trace: object = None
    lines: list = field(default_factory=list)  # notes for standard error


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak(dev) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0


def _free(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _weights(run: Run, seed: int) -> dict:
    return arch.weights(run.config, seed, run.device)


def _classes(run: Run) -> int:
    return run.config["model"]["num_classes"]


def _limit(run: Run, res: Result, name: str, value: float, note: str = "") -> None:
    res.numbers[name] = (value, float(run.limits[name]), note)


def _trace_now(run: Run, tracer, t0: float) -> bool:
    """Whether a traced run's profiler starts now: the last
    ``trace_seconds`` of the window, at a chain's or a step's start."""
    return (run.trace and tracer is None
            and time.perf_counter() - t0 >= run.seconds - run.traffic["trace_seconds"])


def _serve_fn(run: Run, raw: dict):
    return arch.load(run.config).serve_fn(run.config, run.traffic, raw, run.faults)


# ---------------------------------------------------------------------------


def serve(run: Run) -> Result:
    tr, dev = run.traffic, run.device
    B, size, chain = tr["batch"], run.config["image_size"], tr["chain"]
    s = inputs.seeds(run.seed)
    raw = _weights(run, s["weights"])
    call = _serve_fn(run, raw)
    pool_x, _ = inputs.pool(tr["pool_batches"], B, size, s["data"], dev, torch.bfloat16,
                            _classes(run))
    P = len(pool_x)
    rng = np.random.default_rng(s["sample"])
    res = Result()
    with torch.inference_mode():
        for i in range(tr["warmup_batches"]):
            call(pool_x[i % P]).sum()
        if run.trace:
            warm(dev)
        _sync(dev)
        setup = time.perf_counter() - run.t_start
        kept, n, tracer = [], 0, None
        t0 = time.perf_counter()
        while True:
            if _trace_now(run, tracer, t0):
                res.window["untraced"] = (n * B, time.perf_counter() - t0)
                tracer = Tracer(dev)
            acc = torch.zeros((), device=dev)
            for _ in range(chain):
                logits = call(pool_x[n % P])
                acc = acc + logits.sum()
                rows = [int(rng.integers(0, B // 2)), int(rng.integers(B // 2, B))]
                kept.append((n, rows, logits[rows].clone()))
                n += 1
            float(acc)  # the host reads one scalar: the chain is done
            if time.perf_counter() - t0 >= run.seconds:
                break
        elapsed = time.perf_counter() - t0
        if tracer is not None:
            res.trace = tracer.stop()
    res.e2e = {"serve_img_s": n * B / elapsed, "setup_s": setup}
    res.attempted = n * B
    res.window.update(images=n * B, seconds=elapsed, batch=B)
    res.window.setdefault("untraced", (n * B, elapsed))
    res.memory_peak = _peak(dev)
    # the checked sample: seeded batches and the last, both kept rows each
    picks = sorted(set(rng.choice(n, size=min(n, tr["check_batches"] - 1), replace=False)
                       .tolist()) | {n - 1})
    images = torch.cat([pool_x[kept[i][0] % P][kept[i][1]] for i in picks]).float()
    prog = torch.cat([kept[i][2] for i in picks])
    del call, pool_x, kept, logits
    _free(dev)
    t_ref = time.perf_counter()
    ref = check.reference_logits(arch.load(run.config).reference(
        run.config, _weights(run, s["weights"])), images)
    _limit(run, res, "logit_err", check.logit_err(prog, ref), f"{len(picks)} batches, "
           f"{prog.shape[0]} images")
    res.lines.append(f"set-up {setup:.3f} s, window {elapsed:.3f} s ({n} batches), reference "
                     f"{time.perf_counter() - t_ref:.3f} s")
    return res


# ---------------------------------------------------------------------------


def train(run: Run) -> Result:
    from lmnet_tpu_torch.metrics import ConfusionAccumulator
    from lmnet_tpu_torch.train import create_train_state, train_step

    tr, dev = run.traffic, run.device
    B, size = tr["batch"], run.config["image_size"]
    A = arch.load(run.config)
    s = inputs.seeds(run.seed)
    raw = _weights(run, s["weights"])
    model = A.train_model(run.config, tr).to(dev)
    model.load_state_dict(raw, strict=True)
    opt = tr["optimizer"]
    state = create_train_state(model, (B, size, size, 3), seed=s["dropout"], device=dev,
                               epochs=opt["epochs"], steps_per_epoch=opt["steps_per_epoch"])
    step_fn = run.faults.get("train_step", train_step)
    kw = A.train_kwargs(run.config)
    xs, ys = inputs.pool(tr["pool_batches"], B, size, s["data"], dev, torch.float32,
                         _classes(run))
    P = len(xs)
    cm0 = ConfusionAccumulator.init(_classes(run), dev)
    res = Result()
    K = tr["check_steps"]
    prog = {"losses": []}
    beta1 = state.optimizer.param_groups[0]["betas"][0]
    for i in range(K):
        _, loss, _ = step_fn(state, xs[i], ys[i], cm0, **kw)
        prog["losses"].append(float(loss))
        if i == 0:  # the first gradient, as the optimiser holds it (none: zero)
            prog["grad1"] = {
                k: (state.optimizer.state[p]["exp_avg"] / (1 - beta1)).clone()
                if "exp_avg" in state.optimizer.state.get(p, {}) else torch.zeros_like(p)
                for k, p in model.named_parameters()}
    prog["state"] = {k: v.detach().clone() for k, v in model.state_dict().items()}
    if run.trace:
        warm(dev)
    _sync(dev)
    setup = time.perf_counter() - run.t_start
    n, tracer = 0, None
    losses = []
    t0 = time.perf_counter()
    while True:
        if _trace_now(run, tracer, t0):
            res.window["untraced"] = (n * B, time.perf_counter() - t0)
            tracer = Tracer(dev)
        i = K + n
        _, loss, _ = step_fn(state, xs[i % P], ys[i % P], cm0, **kw)
        losses.append(float(loss))  # the host reads the step's loss
        n += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    elapsed = time.perf_counter() - t0
    if tracer is not None:
        res.trace = tracer.stop()
    res.e2e = {"train_img_s": n * B / elapsed, "setup_s": setup}
    res.attempted, res.failed = n, sum(1 for v in losses if not np.isfinite(v))
    res.window.update(images=n * B, seconds=elapsed, batch=B)
    res.window.setdefault("untraced", (n * B, elapsed))
    res.memory_peak = _peak(dev)
    batches = [(xs[i], ys[i]) for i in range(K)]
    del state, model, loss, cm0
    xs = ys = None
    _free(dev)
    raw = _weights(run, s["weights"])
    t_ref = time.perf_counter()
    with check.exact_fp32():
        losses_r, grad_r, state_r = A.train_steps(run.config, tr, raw, batches,
                                                  inputs.generator(s["dropout"], dev))
    nums = check.train_numbers(raw, prog, {"losses": losses_r, "grad1": grad_r,
                                           "state": state_r})
    for name in ("loss", "grad1", "change", "bn_stats"):
        _limit(run, res, name, nums[name][0], nums[name][1])
    res.lines.append(f"left out of the change (reference gradient under 1e-3 of the median "
                     f"leaf's): {int(nums['_left_out'][0])} leaves: {nums['_left_out'][1]}")
    res.lines.append(f"losses program {prog['losses']} reference {losses_r}")
    for name in ("grad1_worst", "change_worst"):
        res.lines.append(f"{name}, a reading not compared: {nums[name][0]!r} "
                         f"({nums[name][1]})")
    res.lines.append(f"set-up {setup:.3f} s, window {elapsed:.3f} s ({n} steps), reference "
                     f"{time.perf_counter() - t_ref:.3f} s")
    return res


# ---------------------------------------------------------------------------


def centre_margin(config: dict, raw: dict, images: torch.Tensor) -> list[float]:
    """Move the head's bias in ``raw`` by the architecture's ``head_shift``
    of the reference's logits over ``images``, so that every class occurs in
    the masks of a model with random weights; returns the shift."""
    A = arch.load(config)
    name, shift = A.head_shift(check.reference_logits(A.reference(config, raw), images))
    with torch.no_grad():
        raw[name] += shift
    return shift.tolist()


def batcher_setup(run: Run, s: dict):
    """An open-loop run's set-up: the weights with the head centred, the
    pool of host images, a ``DynamicBatcher`` around the serving callable
    with every batch size it can form warmed. Returns (weights,
    host images, batcher, notes: the head's shift and the seconds spent)."""
    from lmnet_tpu_torch.serve import DynamicBatcher

    tr, dev = run.traffic, run.device
    size = run.config["image_size"]
    raw = _weights(run, s["weights"])
    imgs, _ = inputs.images_and_masks(tr["pool_images"], size, inputs.generator(s["data"], dev),
                                      dev, classes=_classes(run))
    t = time.perf_counter()
    shift = centre_margin(run.config, raw, imgs[:2])
    host = imgs.cpu().numpy()
    t_centre = time.perf_counter() - t
    batcher = DynamicBatcher(_serve_fn(run, raw), img_size=size, max_batch=tr["max_batch"],
                             max_wait_ms=tr["max_wait_ms"], dtype=torch.bfloat16, device=dev)
    b = 1
    while b <= tr["max_batch"]:  # every bucket the batcher can form
        batcher.predict(host[np.arange(b) % len(host)])
        b *= 2
    return raw, host, batcher, {"head_shift": shift, "centre_s": t_centre,
                                "buckets_s": time.perf_counter() - t - t_centre}


def offer(run: Run, batcher, host, rate: float, seconds: float, s: dict, res: Result):
    """Requests at ``rate`` a second for ``seconds`` (``openloop.schedule``),
    each of consecutive pool images from an offset drawn from the seed;
    with ``run.trace`` the profiler covers the last ``trace_seconds``.
    Returns (the ``openloop.Result``, each request's pool indices, the
    batcher's counters over the window)."""
    tr = run.traffic
    sched = openloop.schedule(rate, seconds, tr["sizes"], s["traffic"])
    offs = np.random.default_rng(s["sample"]).integers(0, len(host), size=len(sched.due))
    idx = [np.arange(o, o + k) % len(host) for o, k in zip(offs, sched.sizes)]
    payloads = [host[i] for i in idx]
    stats0 = dict(batcher.stats)
    tracer = [None]
    first_traced = int(np.searchsorted(sched.due, seconds - tr["trace_seconds"]))

    def payload(i):
        if run.trace and i == first_traced:
            res.window["untraced"] = (int(sched.sizes[:i].sum()), float(sched.due[i]))
            tracer[0] = Tracer(run.device, sync=False)
        return payloads[i]

    out = openloop.drive(batcher.submit, sched, payload, tr["answer_wait_s"])
    stats1 = dict(batcher.stats)
    if tracer[0] is not None:
        res.trace = tracer[0].stop()
    res.window.update(images=int(sched.sizes.sum()), seconds=seconds)
    res.window.setdefault("untraced", (int(sched.sizes.sum()), seconds))
    return out, idx, {k: stats1[k] - stats0[k] for k in stats1}


def latency_line(out, rate, seconds, counters) -> str:
    lat, late = out.latencies_ms(), out.lateness_ms()
    return (f"requests {len(lat)} due in {seconds} s at {rate}/s, answered "
            f"{int(np.sum(~out.failed))}; latency ms p50 {openloop.percentile(lat, 50):.3f} "
            f"p95 {openloop.percentile(lat, 95):.3f} p99 {openloop.percentile(lat, 99):.3f}; "
            f"generator late ms p50 {openloop.percentile(late, 50):.3f} max "
            f"{float(np.nanmax(late)):.3f}; batcher {counters}")


def open_loop(run: Run) -> Result:
    tr, dev = run.traffic, run.device
    s = inputs.seeds(run.seed)
    res = Result()
    raw, host, batcher, notes = batcher_setup(run, s)
    try:
        if run.trace:
            warm(dev)
        _sync(dev)
        setup = time.perf_counter() - run.t_start
        out, idx, res.counters = offer(run, batcher, host, tr["rate_rps"], run.seconds, s, res)
    finally:
        batcher.stop()
    lat = out.latencies_ms()
    res.e2e = {"request_p95_ms": openloop.percentile(lat, 95), "setup_s": setup}
    res.attempted, res.failed = len(lat), int(out.failed.sum())
    res.memory_peak = _peak(dev)
    res.lines.append(latency_line(out, tr["rate_rps"], run.seconds, res.counters)
                     + f"; set-up {setup:.3f} s, of it {notes}")
    del batcher
    _free(dev)
    ref = check.reference_logits(arch.load(run.config).reference(run.config, raw),
                                 torch.from_numpy(host).to(dev))
    scale = check.margin_rms(ref)
    worst = 0.0
    for i, ans in enumerate(out.answers):
        if ans is not None:
            worst = max(worst, check.mask_gap(torch.from_numpy(ans),
                                              ref[torch.as_tensor(idx[i])], scale))
    _limit(run, res, "mask_gap", worst, f"{len(lat) - res.failed} requests, margin RMS "
           f"{scale:.6f}")
    _limit(run, res, "unanswered", float(res.failed), f"of {len(lat)}")
    return res


DRIVERS = {"serve": serve, "train": train, "open_loop": open_loop}
