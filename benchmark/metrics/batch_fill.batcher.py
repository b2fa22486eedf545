"""Images over the slots of the batches the batcher ran in the window
(``DynamicBatcher.stats``: images / (images + padded)): the useful share of
the device's work after padding to a power of two."""

LAYER = "serving batcher: serve/daemon.py::DynamicBatcher"
UNIT = "%"
MOVES = "request_p95_ms"
SOURCE = "program_counter"


def read(ctx):
    c = ctx.counters
    slots = c.get("images", 0) + c.get("padded", 0)
    return 100.0 * c["images"] / slots if slots else None
