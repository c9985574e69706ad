"""Logging and scalar summaries (the port's own copy of
``maxsquareloss_tpu/utils/logging.py``).

``setup_logger`` writes ``train_log.txt`` in the checkpoint dir and to
stdout; ``SummaryWriter`` mirrors every scalar into ``scalars.jsonl``
(``{"tag", "value", "step", "ts"}`` per line, the JAX package's names and
format) and into TensorBoard when ``tensorboardX`` is installed.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time


def setup_logger(
    checkpoint_dir: str, name: str = "maxsquareloss_torch", file: bool = True,
    main: bool = True,
) -> logging.Logger:
    """``file=False`` gives a console-only logger. ``main=False`` (a rank
    other than 0 of several processes): no file, and warnings only."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO if main else logging.WARNING)
    logger.propagate = False  # avoid duplicate lines via the root logger
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    if file and main:
        fh = logging.FileHandler(os.path.join(checkpoint_dir, "train_log.txt"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    return logger


class SummaryWriter:
    """tensorboardX SummaryWriter with a JSONL mirror (``scalars.jsonl``),
    so runs are machine-readable without TensorBoard."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "scalars.jsonl"), "a")
        self._tb = None
        try:
            from tensorboardX import SummaryWriter as TBWriter

            self._tb = TBWriter(logdir)
        except ImportError:
            pass

    def add_scalar(self, tag: str, value, step: int):
        value = float(value)
        self._jsonl.write(
            json.dumps({"tag": tag, "value": value, "step": int(step), "ts": time.time()})
            + "\n"
        )
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def add_image(self, tag: str, img_hwc, step: int):
        """img_hwc: (H, W, 3) float [0,1] or uint8."""
        if self._tb is not None:
            import numpy as np

            arr = np.asarray(img_hwc)
            if arr.dtype != "uint8":
                arr = (arr * 255).clip(0, 255).astype("uint8")
            self._tb.add_image(tag, arr, step, dataformats="HWC")

    def flush(self):
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class NullWriter:
    """No-op writer."""

    def add_scalar(self, tag: str, value, step: int):
        pass

    def add_image(self, tag: str, img_hwc, step: int):
        pass

    def flush(self):
        pass

    def close(self):
        pass
