"""Debug and observability switches of the port (counterpart of
``maxsquareloss_tpu/utils/debug.py``).

- ``--debug_nans``: ``anomaly_mode`` runs a train step in autograd's anomaly
  mode (a backward that makes a NaN raises, naming the forward op); the
  step also raises ``FloatingPointError`` on a loss that is not finite
  (``train/steps.py``), as ``jax_debug_nans`` stops a run at its first NaN.
- ``--profile``: ``StepProfiler`` captures a ``torch.profiler`` trace (host
  and, on the card, device activity) of iterations 2-5 of the training
  loop, past the first steps' allocations and kernel builds, and writes it
  as a Chrome trace under ``<checkpoint_dir>/profile``, where the JAX
  trainer writes its trace.
"""

from __future__ import annotations

import contextlib
import os

import torch


def anomaly_mode(enabled: bool):
    """Autograd's anomaly mode inside the block when ``enabled``."""
    return torch.autograd.detect_anomaly() if enabled else contextlib.nullcontext()


class StepProfiler:
    """A ``torch.profiler`` trace of iterations [``first``, ``last``) of a
    training loop, ``iteration`` counting the steps done:
    ``before_step(iteration)`` starts it at ``first``,
    ``after_step(iteration)`` ends it once ``last`` is reached,
    ``stop(iteration)`` ends it early (a run shorter than ``last``). Nothing
    runs unless ``enabled``."""

    def __init__(self, logdir: str, enabled: bool, device: torch.device,
                 first: int = 2, last: int = 6):
        self.dir = os.path.join(logdir, "profile")
        self.enabled, self.device = enabled, device
        self.first, self.last = first, last
        self._prof = None
        self._started_at = None
        self.path: str | None = None  # the last trace written

    def before_step(self, iteration: int) -> None:
        if self.enabled and self._prof is None and iteration == self.first:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
            self._started_at = iteration

    def after_step(self, iteration: int) -> str | None:
        if self._prof is not None and iteration >= self.last:
            return self.stop(iteration)
        return None

    def stop(self, iteration: int) -> str | None:
        """End the trace at ``iteration`` (the device's work included) and
        write it; its path, or None when no trace was running."""
        if self._prof is None:
            return None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(
            self.dir, f"iterations_{self._started_at}-{iteration - 1}.pt.trace.json")
        self._prof.export_chrome_trace(self.path)
        self._prof = None
        return self.path
