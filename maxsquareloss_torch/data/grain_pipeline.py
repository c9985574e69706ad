"""The grain-backed input pipeline, ``--loader grain`` (the port's own copy
of ``maxsquareloss_tpu/data/grain_pipeline.py``).

Multiprocess decode workers from the ``grain`` package with the batch
contract of ``SegDataLoader``: ``(images (N,H,W,3), labels (N,H,W), names)``.
A sample's augmentation draws from ``default_rng((seed, epoch, key))`` and
each epoch reshuffles through a sampler seed of its own, so the stream is
the same for any worker count; shards are the DDP ranks' (``shard_index`` =
rank, ``shard_count`` = world), and a padded val shard's slots take
``make_pad_sample``. ``grain`` is imported where an epoch is built; where it
is not installed, constructing the loader raises ``ImportError``.
"""

from __future__ import annotations

import importlib.util
from typing import Iterator

import numpy as np

from maxsquareloss_torch.data.loader import _PAD_SAMPLE_NAME, make_pad_sample


def require_grain() -> None:
    """Raise ImportError, saying so, where the grain package is not installed."""
    if importlib.util.find_spec("grain") is None:
        raise ImportError("--loader grain needs the grain package (grain.python), which is not "
                          "installed on this machine; use --loader threads")


class _KeySource:
    """grain RandomAccessDataSource yielding record keys (decode happens in
    the map operation, where the epoch is known).

    ``keys`` maps source positions to dataset indices; a ``-1`` key is a
    shard-padding slot (all-ignore sample, excluded from metrics)."""

    def __init__(self, n_or_keys):
        if isinstance(n_or_keys, int):
            self._keys = None
            self._n = n_or_keys
        else:
            self._keys = np.asarray(n_or_keys)
            self._n = len(self._keys)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, key: int) -> int:
        if self._keys is None:
            return int(key)
        return int(self._keys[int(key)])


class GrainSegLoader:
    """grain.DataLoader wrapper with the SegDataLoader interface.

    One single-epoch grain DataLoader is built per ``__iter__`` so the
    trainer's set_epoch / abandoned-generator semantics match the thread
    loader exactly.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 0,
        seed: int = 0,
        drop_last: bool = True,
        pad_last: bool = False,
        shard_index: int = 0,
        shard_count: int = 1,
    ):
        require_grain()
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        # grain worker_count=0 runs in-process; >0 forks decode workers
        self.num_workers = max(0, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.shard_index = shard_index
        self.shard_count = max(1, shard_count)
        self.epoch = 0
        self._skip_batches = 0

    # -- SegDataLoader interface ------------------------------------------

    @property
    def num_iterations(self) -> int:
        n = len(self.dataset)
        if self.shard_count > 1:
            # pad_last (val): shards round UP so every sample is evaluated
            # exactly once (short shards pad with all-ignore samples);
            # train drops the remainder for lockstep equal lengths
            n = -(-n // self.shard_count) if self.pad_last \
                else n // self.shard_count
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def set_skip(self, n_batches: int):
        self._skip_batches = int(n_batches)

    def __len__(self) -> int:
        return self.num_iterations

    # ----------------------------------------------------------------------

    def _build(self, epoch: int, skip_batches: int = 0):
        import grain.python as grain

        ds, seed = self.dataset, self.seed

        class DecodeSample(grain.MapTransform):
            def map(self, key: int):
                if key < 0:  # shard-padding slot
                    return make_pad_sample(ds, seed, epoch)
                rng = np.random.default_rng((seed, epoch, int(key)))
                return ds.get(int(key), rng)

        if self.pad_last and self.shard_count > 1:
            # val: EVERY sample must be scored exactly once. grain's
            # even_split does not guarantee that with remainders, so shard
            # at the key-source level (same interleaved scheme as
            # SegDataLoader) and pad short shards with -1 slots.
            per = -(-len(ds) // self.shard_count)
            keys = np.arange(len(ds))[self.shard_index :: self.shard_count]
            if len(keys) < per:
                keys = np.concatenate(
                    [keys, np.full(per - len(keys), -1, keys.dtype)]
                )
            source = _KeySource(keys)
            shard_options = grain.NoSharding()
        else:
            source = _KeySource(len(ds))
            shard_options = grain.ShardOptions(
                shard_index=self.shard_index,
                shard_count=self.shard_count,
                drop_remainder=self.shard_count > 1,
            )
        sampler = grain.IndexSampler(
            num_records=len(source),
            shard_options=shard_options,
            shuffle=self.shuffle,
            # fresh permutation per epoch, reproducible across runs
            seed=(self.seed * 1_000_003 + epoch) % (2**31 - 1),
            num_epochs=1,
        )
        if skip_batches:
            # Exact mid-epoch resume WITHOUT decoding the skipped samples:
            # the IndexSampler is random-access, so enumerate this shard's
            # visit order (record metadata only — no decode), drop the first
            # skip_batches*batch_size positions, and replay the tail through
            # a sequential sampler over the already-shuffled dataset keys.
            # Per-sample aug RNG is keyed by (seed, epoch, dataset_key), so
            # the tail is bit-identical to the uninterrupted epoch's tail
            # (mirrors SegDataLoader's index-slice resume).
            if isinstance(shard_options, grain.NoSharding):
                per = len(source)
                idxs = range(per)
            else:
                per = (
                    len(source) // self.shard_count
                    if self.shard_count > 1
                    else len(source)
                )
                idxs = range(
                    self.shard_index,
                    self.shard_index + per * self.shard_count,
                    self.shard_count,
                )
            order = [source[sampler[i].record_key] for i in idxs]
            order = order[skip_batches * self.batch_size :]
            if not order:
                return None
            source = _KeySource(order)
            sampler = grain.IndexSampler(
                num_records=len(source),
                shard_options=grain.NoSharding(),
                shuffle=False,
                num_epochs=1,
            )
        return grain.DataLoader(
            data_source=source,
            sampler=sampler,
            operations=[DecodeSample()],
            worker_count=self.num_workers,
        )

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray, list[str]]]:
        epoch = self.epoch
        self.epoch = epoch + 1
        skip = self._skip_batches
        self._skip_batches = 0
        loader = self._build(epoch, skip_batches=skip)
        if loader is None:  # resume consumed the whole epoch
            return
        # NOTE: no trailing all-pad-batch loop is needed — shard-level -1
        # key padding already makes every shard's stream exactly
        # num_iterations batches long (per = ceil(n / shard_count) keys).
        batch: list = []
        for sample in loader:
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield self._stack(batch)
                batch = []
        if batch and not self.drop_last:
            if self.pad_last and len(batch) < self.batch_size:
                x_last, y_last, _ = batch[-1]
                pad = (x_last, np.full_like(y_last, -1), _PAD_SAMPLE_NAME)
                batch += [pad] * (self.batch_size - len(batch))
            yield self._stack(batch)

    @staticmethod
    def _stack(batch):
        xs = np.stack([b[0] for b in batch])
        ys = np.stack([b[1] for b in batch])
        names = [str(b[2]) for b in batch]
        return xs, ys, names
