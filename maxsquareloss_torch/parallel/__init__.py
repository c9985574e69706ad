"""Data parallelism of the port: one process per card, ``torch.distributed``
and ``DistributedDataParallel`` under ``torchrun`` (the counterpart of
``maxsquareloss_tpu/parallel/``)."""
