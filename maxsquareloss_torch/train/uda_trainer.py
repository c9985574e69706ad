"""UDA trainer: source CE + target max-square family, one step per
(source, target) batch pair (counterpart of
``maxsquareloss_tpu/train/uda_trainer.py``).

Each iteration consumes one labeled source batch (GTA5 or SYNTHIA) and one
unlabeled target batch (Cityscapes) and takes one optimizer step of
``train/steps.make_uda_train_step``. The epoch is ``zip(source, target)``,
so it ends with the shorter loader; both loaders have their epoch pinned and
both skip the saved batch offset on a mid-epoch resume. With several
processes both loaders read the rank's shard of every global batch.
"""

from __future__ import annotations

from typing import Iterable

from maxsquareloss_torch.data.loader import device_prefetch
from maxsquareloss_torch.train.steps import make_uda_train_step
from maxsquareloss_torch.train.trainer import Trainer


class UDATrainer(Trainer):
    def __init__(
        self,
        cfg,
        source_loader: Iterable,
        target_loader: Iterable,
        val_loader: Iterable | None = None,
        **kw,
    ):
        self.target_loader = target_loader
        self._check_sharded(target_loader)
        super().__init__(cfg, train_loader=source_loader, val_loader=val_loader, **kw)

    def _make_train_step(self):
        return make_uda_train_step(self.cfg)

    def _epoch_batches(self):
        for loader in (self.train_loader, self.target_loader):
            if hasattr(loader, "set_epoch"):
                # zip abandons the longer loader's generator: without this
                # the source loader would replay epoch 0's draws forever
                loader.set_epoch(self.current_epoch)
        self._consume_resume_skip(self.train_loader, self.target_loader)
        src = device_prefetch(iter(self.train_loader), self.device)
        tgt = device_prefetch(iter(self.target_loader), self.device)
        return zip(src, tgt)

    def _run_step(self, batch):
        (xs, ys, _), (xt, _, _) = batch
        return self.train_step(self.state, xs, ys, xt)

    def _batch_images(self, batch) -> int:
        (xs, _, _), (xt, _, _) = batch
        return xs.shape[0] + xt.shape[0]

    def _expected_epoch_batches(self) -> int | None:
        ns = getattr(self.train_loader, "num_iterations", None)
        nt = getattr(self.target_loader, "num_iterations", None)
        if ns is None or nt is None:
            return None
        return min(ns, nt)  # zip(source, target) ends at the shorter loader
