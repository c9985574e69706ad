"""Supervised Trainer: the host loop around the port's train and eval steps
(counterpart of ``maxsquareloss_tpu/train/trainer.py``).

It owns the loaders, the model and its SGD state, and runs the epoch loop:
one train step per batch at the poly LR, every metric logged per
iteration (``scalars.jsonl``, the JAX package's names), validation every
``validation_epoch`` epochs (mIoU, and the 16/13-class SYNTHIA protocol),
best and latest checkpoints, ``--save_iter`` mid-epoch checkpoints, resume
(``--continue_training``, by default from the run's latest checkpoint, at
the exact batch of a mid-epoch save) and SIGTERM preemption (finish the
step, checkpoint mid-epoch, return).

Batches reach the device through ``data.loader.device_prefetch`` on the
current stream. As in the JAX loop, the metrics come back to the host every
iteration; here in ONE ``torch.stack(...).tolist()``, a single sync.

``--profile`` writes a ``torch.profiler`` trace of iterations 2-5 under
``<checkpoint_dir>/profile`` (``utils.debug.StepProfiler``), with the
steps' spans (``utils.debug.span``: forward, loss, backward, block
backward, optimizer, host syncs) on its timeline, and logs each span's
device and host ms a step over those iterations;
``--debug_nans`` is the train steps' (anomaly mode, ``FloatingPointError``
on a loss that is not finite).

With several processes (``parallel/``) every rank runs this loop over its
shard of the loaders in lockstep: the steps return the global batch's
metrics, validation sums the ranks' confusion matrices before any metric,
and a SIGTERM on any rank stops every rank at the same
``--preempt_sync_steps`` boundary. Rank 0 alone writes checkpoints (the
other ranks wait for it), scalars, images, the trace and the log file; the
others log warnings only. Every rank resumes from the same file.

Under ``--sp N`` (``parallel/spatial.py``) the ranks of a space group read
the same batches; the steps take each rank's rows, and validation runs the
spatially partitioned eval step on each rank's rows of every image and
label (rank 0's preview images gathered from its group).
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Iterable

import numpy as np
import torch

from maxsquareloss_torch.config import TrainConfig, check_supported
from maxsquareloss_torch.data.loader import device_prefetch
from maxsquareloss_torch.data.palette import decode_labels, inv_preprocess
from maxsquareloss_torch.metrics import Eval
from maxsquareloss_torch.models.deeplabv2 import init_deeplabv2
from maxsquareloss_torch.optim import make_sgd
from maxsquareloss_torch.parallel import ddp, spatial
from maxsquareloss_torch.train import checkpoint as ckpt_lib
from maxsquareloss_torch.train.steps import (
    TrainState,
    make_eval_step,
    make_supervised_train_step,
    make_train_state,
    model_config,
)
from maxsquareloss_torch.utils.debug import StepProfiler, sync
from maxsquareloss_torch.utils.device import resolve_device
from maxsquareloss_torch.utils.logging import NullWriter, SummaryWriter, setup_logger


def val_preview_image(x0: np.ndarray, numpy_transform: bool) -> np.ndarray:
    """(H, W, 3) float RGB in [0,1] preview of one val input: uint8 batches
    (--device_normalize) are the RGB image already, float ones are inverted."""
    if x0.dtype == np.uint8:
        return x0.astype(np.float32) / 255.0
    return inv_preprocess(x0[None], numpy_transform=numpy_transform)[0]


class Trainer:
    def __init__(
        self,
        cfg: TrainConfig,
        train_loader: Iterable,
        val_loader: Iterable | None = None,
        model: torch.nn.Module | None = None,
        logger=None,
        writer=None,
        num_eval_classes: int | None = None,
        synthia_protocol: bool = False,
    ):
        check_supported(cfg)
        if cfg.quantize:
            raise ValueError(f"--quantize {cfg.quantize} is for evaluation and serving "
                             "(tools.evaluate, tools.predict, tools.export_inference, the "
                             "bench's infer mode); the trainers keep float32 weights")
        self.cfg = cfg
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.space = spatial.space_group(cfg.sp)
        self._check_sharded(train_loader, val_loader)
        self.device = resolve_device(cfg.device)
        self.is_main = ddp.is_main()
        self.logger = logger or setup_logger(cfg.checkpoint_dir, main=self.is_main)
        if writer is None:
            writer = SummaryWriter(cfg.checkpoint_dir) if self.is_main else NullWriter()
        self.writer = writer
        self.synthia_protocol = synthia_protocol
        self.num_eval_classes = num_eval_classes or cfg.num_classes

        if model is None:
            # the JAX package's initial weights for the same --seed
            model = init_deeplabv2(model_config(cfg), cfg.seed, device=self.device)
        else:
            model = model.to(device=self.device, memory_format=torch.channels_last).eval()
        self.model = model
        self.state: TrainState = make_train_state(model, cfg, self.space)
        self.train_step = self._make_train_step()
        self.eval_step = make_eval_step(cfg, model, self.num_eval_classes, self.space)

        self.current_epoch = 0
        self.best_miou = 0.0
        self._epoch_batch = 0       # batches consumed in the current epoch
        self._resume_skip = 0       # batches to skip on the next epoch (resume)
        self._preempt_requested = False  # SIGTERM seen
        self.preempted = False           # stopped early
        self.profiler = StepProfiler(cfg.checkpoint_dir, cfg.profile and self.is_main,
                                     self.device, logger=self.logger)

    def _check_sharded(self, *loaders):
        """With several processes every loader must read this rank's data
        group's shard: an unsharded one would give each group the same
        images."""
        groups = ddp.world() // max(self.cfg.sp, 1)
        for loader in loaders:
            if loader is not None and getattr(loader, "shard_count", 1) != groups:
                raise ValueError(f"a loader reads {getattr(loader, 'shard_count', 1)} "
                                 f"shard(s), but there are {groups} data groups of "
                                 f"{ddp.world()} processes (tools/common.make_loader shards "
                                 "by data group)")

    # hooks for UDATrainer -------------------------------------------------

    def _make_train_step(self):
        return make_supervised_train_step(self.cfg, self.space)

    def _consume_resume_skip(self, *loaders):
        """Mid-epoch resume: the next epoch starts at the saved batch offset
        (same epoch → same shuffle and augmentations → the exact tail)."""
        skip, self._resume_skip = self._resume_skip, 0
        self._epoch_batch = skip
        if skip:
            for loader in loaders:
                if hasattr(loader, "set_skip"):
                    loader.set_skip(skip)

    def _epoch_batches(self):
        if hasattr(self.train_loader, "set_epoch"):
            # pin the epoch: resume must restart it with the same draws
            self.train_loader.set_epoch(self.current_epoch)
        self._consume_resume_skip(self.train_loader)
        return device_prefetch(iter(self.train_loader), self.device)

    def _run_step(self, batch):
        xs, ys, _ = batch
        return self.train_step(self.state, xs, ys)

    def _batch_images(self, batch) -> int:
        return batch[0].shape[0]

    def _expected_epoch_batches(self) -> int | None:
        return getattr(self.train_loader, "num_iterations", None)

    def _epoch_complete(self) -> bool:
        exp = self._expected_epoch_batches()
        return exp is None or self._epoch_batch >= exp

    # ----------------------------------------------------------------------

    def main(self):
        path = self.cfg.pretrained_ckpt_file
        if not path and self.cfg.continue_training:
            # in-place resume: default to this run dir's latest checkpoint
            cand = os.path.join(self.cfg.checkpoint_dir, ckpt_lib.LATEST)
            if os.path.exists(cand):
                path = cand
            else:
                self.logger.warning(
                    "--continue_training set but no --pretrained_ckpt_file "
                    f"given and {cand} does not exist — starting fresh"
                )
        if path:
            self.load_checkpoint(path)
        self.train()

    def load_checkpoint(self, path: str):
        """Weights from any ``.pth`` (bare, ``module.``-prefixed, full); the
        optimizer, iteration, epoch, best mIoU and batch offset too when
        ``--continue_training`` is set and the file is a checkpoint of this
        trainer. Otherwise a fresh optimizer at iteration 0 (a pretrained
        init, as the reference resumes only under --continue_training)."""
        blob = ckpt_lib.load_checkpoint(path)
        ckpt_lib.load_weights(self.model, blob, self.cfg.num_classes)
        # a fresh optimizer; the DDP wrapper stays (one per model)
        self.state = dataclasses.replace(self.state, optimizer=make_sgd(self.model, self.cfg),
                                         iteration=0)
        if self.cfg.continue_training and ckpt_lib.is_training_checkpoint(blob):
            ckpt_lib.restore_optimizer_state(self.model, self.state.optimizer, blob["optimizer"])
            self.state.iteration = int(blob["iteration"])
            self.current_epoch = int(blob["epoch"])
            self.best_miou = float(blob["best_MIou"])
            self._resume_skip = int(blob.get("epoch_batch", 0))
            self.logger.info(f"loaded checkpoint {path} (epoch {self.current_epoch}, "
                             f"iteration {self.state.iteration}, best mIoU {self.best_miou:.4f})")
        else:
            self.logger.info(f"loaded weights from {path}")

    def save_checkpoint(self, is_best: bool = False, mid_epoch: bool = False) -> str:
        # records COMPLETED epochs; a mid-epoch save carries the batch offset
        # within its epoch, so resume continues from the exact batch
        # rank 0 writes; the others wait until the file is there
        completed = self.current_epoch if mid_epoch else self.current_epoch + 1
        path = os.path.join(self.cfg.checkpoint_dir, ckpt_lib.LATEST)
        if self.is_main:
            path = ckpt_lib.save_checkpoint(
                self.cfg.checkpoint_dir, self.model, self.state.optimizer, self.state.iteration,
                completed, self.best_miou, is_best=is_best,
                epoch_batch=self._epoch_batch if mid_epoch else 0,
            )
        ddp.barrier()
        return path

    # graceful preemption (SIGTERM → checkpoint + clean return) ------------

    def _install_preempt_handler(self):
        """SIGTERM sets a flag; the loop acts on it at the next step
        boundary. Returns the previous handler (restored after train())."""
        if not self.cfg.preempt_save:
            return None

        def _on_sigterm(signum, frame):
            self._preempt_requested = True
            self.logger.info("SIGTERM received — will checkpoint and exit at the next step boundary")

        try:
            return signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:
            # signal.signal works in the main thread only; a trainer driven
            # from another thread skips this
            return None

    def _preempt_now(self) -> bool:
        """The preemption decision after a step. One process: the flag
        itself. Several: a checkpoint needs every rank, and SIGTERMs land
        at different times, so every ``--preempt_sync_steps`` iterations
        (the global iteration, the same on every rank) the ranks take the
        MAX of their flags and all stop together, as the JAX package's
        processes do."""
        if not self.cfg.preempt_save:
            return False
        if ddp.world() == 1:
            return self._preempt_requested
        if self.state.iteration % max(1, self.cfg.preempt_sync_steps):
            return False
        return ddp.any_flag(self._preempt_requested)

    # ----------------------------------------------------------------------

    def train(self):
        stop_iter = self.cfg.effective_iter_stop()
        prev_handler = self._install_preempt_handler()
        try:
            for epoch in range(self.current_epoch, self.cfg.epoch_num):
                if self.state.iteration >= stop_iter:
                    # e.g. resuming a checkpoint already at iter_stop: do NOT
                    # run (and checkpoint) a step past the configured stop
                    self.logger.info("already at iter_stop — nothing to train")
                    break
                self.current_epoch = epoch
                self.train_one_epoch()
                if self.state.iteration >= stop_iter:
                    self.logger.info("reached iter_stop — finishing")
                # an iter_stop that lands mid-epoch checkpoints as mid-epoch
                mid = not self._epoch_complete()
                if self.preempted:
                    # grace periods are short: no validation, save, leave
                    self.save_checkpoint(mid_epoch=mid)
                    self.logger.info(f"preempted — checkpoint saved at iter {self.state.iteration}; "
                                     "resume with --continue_training")
                    break
                if self.val_loader is not None and (epoch + 1) % self.cfg.validation_epoch == 0:
                    miou = self.validate()
                    is_best = miou > self.best_miou
                    self.best_miou = max(self.best_miou, miou)
                    self.save_checkpoint(is_best=is_best, mid_epoch=mid)
                else:
                    self.save_checkpoint(mid_epoch=mid)
                if self.state.iteration >= stop_iter:
                    break
            self.writer.flush()
        finally:
            # a run that ends before the trace's last iteration writes what it has
            if self.profiler.stop(self.state.iteration):
                self.logger.info(f"wrote profiler trace {self.profiler.path}")
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)

    def train_one_epoch(self):
        cfg = self.cfg
        t0, imgs = time.time(), 0
        last_metrics = {}
        batches = self._epoch_batches()
        if cfg.tqdm and self.is_main:
            try:
                from tqdm import tqdm as _tqdm

                batches = _tqdm(batches, desc=f"epoch {self.current_epoch}",
                                total=self._expected_epoch_batches(), leave=False)
            except ImportError:
                pass
        for batch in batches:
            self.profiler.before_step(self.state.iteration)
            self.state, metrics = self._run_step(batch)
            self._epoch_batch += 1
            it = self.state.iteration
            if self.profiler.after_step(it):
                self.logger.info(f"wrote profiler trace {self.profiler.path}")
            imgs += self._batch_images(batch)
            # every metric to the host in one sync (the JAX loop reads each)
            with sync("metrics"):
                m = dict(zip(metrics, torch.stack(list(metrics.values())).tolist()))
            last_metrics = m
            for k, v in m.items():
                self.writer.add_scalar(f"train/{k}", v, it)
            if it % 20 == 0 or it <= 1:
                self.logger.info(f"epoch {self.current_epoch} iter {it}: "
                                 + " ".join(f"{k}={v:.5f}" for k, v in m.items()))
            if cfg.save_iter and it % cfg.save_iter == 0:
                self.save_checkpoint(mid_epoch=True)
            if self._preempt_now():
                self.preempted = True
                break
            if it >= cfg.effective_iter_stop():
                break
        dt = time.time() - t0
        if imgs:
            self.writer.add_scalar("train/images_per_sec", imgs / dt, self.state.iteration)
        return last_metrics

    def validate(self) -> float:
        """Cityscapes-style validation → mIoU (16-class under SYNTHIA)."""
        ev = Eval(self.num_eval_classes)
        shown = 0
        it = self.state.iteration
        cm_sum = torch.zeros((self.num_eval_classes,) * 2, dtype=torch.int64, device=self.device)
        space = self.space
        for xs, ys, _ in device_prefetch(iter(self.val_loader), self.device):
            if space is None:
                cm, argpred = self.eval_step(xs, ys)
            else:
                heights = (xs.shape[1], ys.shape[1])
                (a, b), (c, d) = space.own(heights[0]), space.own(heights[1])
                cm, argpred = self.eval_step(xs[:, a:b], ys[:, c:d], heights)
            cm_sum += cm
            if space is not None and shown < self.cfg.show_num_images:
                with torch.inference_mode():  # every rank of the group: collective
                    argpred = spatial.gather_rows(argpred, ys.shape[1], space)
            if self.is_main and shown < self.cfg.show_num_images:
                self.writer.add_image(f"val/pred_{shown}",
                                      decode_labels(argpred[0].cpu().numpy())[0] / 255.0, it)
                self.writer.add_image(f"val/gt_{shown}",
                                      decode_labels(ys[0].cpu().numpy())[0] / 255.0, it)
                self.writer.add_image(f"val/image_{shown}",
                                      val_preview_image(xs[0].cpu().numpy(),
                                                        self.cfg.numpy_transform), it)
            shown += 1
        # this rank's shard (pad slots are all-ignore) summed over the ranks:
        # the one-process matrix exactly
        ev.add_confusion_matrix(ddp.all_reduce_sum(cm_sum))
        pa = ev.Pixel_Accuracy()
        mpa = ev.Mean_Pixel_Accuracy()
        miou = ev.Mean_Intersection_over_Union()
        fwiou = ev.Frequency_Weighted_Intersection_over_Union()
        for tag, v in [("PA", pa), ("MPA", mpa), ("MIoU", miou), ("FWIoU", fwiou)]:
            self.writer.add_scalar(f"val/{tag}", v, it)
        msg = f"validation @ iter {it}: PA={pa:.4f} MPA={mpa:.4f} MIoU={miou:.4f} FWIoU={fwiou:.4f}"
        if self.synthia_protocol:
            miou16 = ev.Mean_Intersection_over_Union_16()
            miou13 = ev.Mean_Intersection_over_Union_13()
            self.writer.add_scalar("val/MIoU_16", miou16, it)
            self.writer.add_scalar("val/MIoU_13", miou13, it)
            msg += f" MIoU_16={miou16:.4f} MIoU_13={miou13:.4f}"
            miou = miou16
        self.logger.info(msg)
        ev.Print_Every_class_Eval(self.logger)
        return miou
