"""Device operations launched inside the program's ``lmnet.fold`` spans
(``serve/engine.py``: the weight and bias casts, BatchNorm's scale and shift
and the other folds of weights alone, redone on every forward) over the
traced batches: the launches a batch that a fold cache would save. None
where the trace holds no ``lmnet.*`` span (a program without them); 0 where
it holds spans and no fold launched anything."""

LAYER = "deploy weight folds by span (lmnet.fold): serve/engine.py::_wb, _bn_affine"
UNIT = "launches/batch"
MOVES = "serve_img_s"
SOURCE = "device_trace"


def read(ctx):
    if ctx.trace is None or not any(h.startswith("lmnet.") for d in ctx.trace.device
                                    for h in d.host):
        return None
    batches = ctx.traced_images() / ctx.window["batch"]
    if batches <= 0:
        return None
    return sum("lmnet.fold" in d.host for d in ctx.trace.device) / batches
