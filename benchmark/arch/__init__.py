"""Architectures, and the one place the harness finds a configuration's.

A configuration (``configs/<name>.json``) names it under ``"arch"``; one
without the key is ``"lmnet"``. The module ``arch/<arch>.py`` is the glue
between the harness and both sides: it alone imports the port's model and
the plain reference ``reference/<arch>.py``. It gives, each a function of
the configuration's dict (``model``, ``image_size``, ``dtype``, ...):

* ``param_specs(config)``: the state dict's entries in order, as
  (name, shape, kind, fan_in), kinds from ``inputs._RANGES`` or 'w', 'b',
  'w_se' (a bound from fan_in);
* ``serve_fn(config, traffic, raw, faults)``: the program's serving
  callable, NHWC images -> NHWC logits, on the raw weights ``raw`` with the
  traffic's ``deploy`` options; it takes the architecture's own fault hooks
  from ``faults``;
* ``train_model(config, traffic)``: the port's train-mode module, built from
  the configuration and the traffic's ``model`` options, for
  ``train.create_train_state``; ``train_kwargs(config)``: the keyword
  arguments ``train.train_step`` needs beyond (state, images, labels, cm);
* ``reference(config, raw, q=None)``: the plain reference model, with a
  ``forward(x)`` of NHWC float32 logits, every weight and activation
  rounded by ``q``;
* ``train_steps(config, traffic, raw, batches, generator, q=None,
  batch_slice=slice(None))``: the reference's checked steps, dropout drawn
  from ``generator`` in the program's order: (losses, first gradient,
  state after), the state's names split into trained leaves and running
  statistics by ``reference.train.is_param``, as the program's are;
* ``head_shift(ref_logits)``: (the head's bias entry, the shift that
  centres the classes' mean logits over the reference's logits);
* ``forward_flops(config, train)``: one image's operations, the deploy
  graph's or (``train``) the train-mode graph's.
"""

from __future__ import annotations

import importlib

from lmbench import inputs

DEFAULT = "lmnet"


def name(config: dict) -> str:
    return config.get("arch", DEFAULT)


def load(config: dict):
    """The module ``arch/<arch>.py`` of ``config``."""
    return importlib.import_module(f"arch.{name(config)}")


def weights(config: dict, seed: int, device) -> dict:
    """The raw float32 weights of ``config``'s model, drawn from ``seed``."""
    return inputs.weights(load(config).param_specs(config), seed, device)
