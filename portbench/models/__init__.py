"""One module per architecture, ``models/<backbone>.py``, picked by a
configuration's ``model.backbone`` (``load``). It holds all that the
drivers need of the model, so that a new architecture is a configuration
file, a module here, its plain forward under ``reference/`` and entries in
``BENCHMARK.json``, with no driver edited:

- ``make_weights(model, seed, device)``: reference-layout float32 weights
  from the seed, made on the device;
- ``train_config(cell, device)``: the port's run configuration;
  ``port_model(cfg, sd, device, eval_mode)``: the port's model with the
  weights ``sd``; ``port_int8(model, cfg, images)``: its own int8 path (the
  evaluation and serving control), where it has one;
- ``port_params(model)``: the port model's trainable parameters by
  reference key; ``first_gradient_norms(optimizer, params, sd0, cfg)``: by
  key, the norm of the first gradient as the port's optimizer got it,
  worked out from its state after one step;
- ``reference(model)``: the plain forward, the trainable leaves and the
  optimizer (``reference/uda.Plain``);
- ``step_work(cell)`` and ``tta_work(cell, n)``: model FLOPs of a train
  step (one card's images) and of a test-time-augmented batch of ``n``
  images (a request is ``n`` = 1), with the peak of the cell's compute
  dtype and the launch lists that the roofline readers read
  (``metrics/<metric>.json``'s ``work``).
"""

from __future__ import annotations

import importlib


def load(config: dict):
    """The module of the configuration's architecture."""
    return importlib.import_module(f"portbench.models.{config['model']['backbone']}")
