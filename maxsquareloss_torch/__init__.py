"""maxsquareloss_torch — the PyTorch/CUDA port of ``maxsquareloss_tpu``.

The package mirrors the JAX package module for module (``models/``,
``ops/``, ``train/``, ``metrics``, ``convert``) and keeps its public layout:
images and logits are NHWC at every public function. Inside the model the
trunk runs as NCHW views in ``torch.channels_last`` memory format, which is
the physical NHWC layout the hand-written Hopper kernels take.

What is ported so far:
- the forward/serving path: uint8 batch → normalize → DeepLabV2-ResNet101
  → align-corners upsample → argmax → confusion matrix / mIoU
  (``train/evaluator.py``) or trainIds (``predict.py``);
- the supervised and UDA train steps (``train/steps.py``): source CE,
  every target mode with self-produced guidance and the IW histogram
  (``ops/``), one backward, torch SGD over the 1x/10x groups at the poly
  LR (``optim.py``);
- training from the command line: the GTA5 / SYNTHIA / Cityscapes / NTHU
  cross-city datasets, transforms and ``SegDataLoader`` (``data/``),
  ``Trainer`` and ``UDATrainer`` with validation, reference-layout ``.pth``
  checkpoints, resume and preemption (``train/``), the flag-for-flag config
  (``config.py``) and the CLIs ``tools/{train_source,solve_gta5,
  solve_crosscity}.py``; a trainer starts from the JAX package's initial
  weights for its ``--seed`` (``utils/jax_random.py``);
- serving and data tools: ``tools/evaluate.py``, ``tools/predict.py``,
  ``tools/prepare_dataset.py``;
- mixed precision and remat: ``--compute_dtype bfloat16`` (activations in
  bf16, parameters, optimizer and checkpoints fp32, logits fp32) and
  ``--remat stages`` (each ResNet stage recomputed in the backward) through
  the steps, the trainers, evaluation, prediction and the bench;
- the benchmark entry point ``bench.py`` (with ``experiments/bench_e2e.py``),
  the adaptation-efficacy harness (``experiments/adaptation_efficacy.py``)
  and the matmul calibration probe (``experiments/bench_matmul.py``).
The 29 stride-1 identity bottlenecks of ResNet-101 run in one fused CUDA
kernel each, in fp32 or bf16 (``kernels/fused_block.py``, ``csrc/fused_bottleneck.cu``;
with grad enabled the kernel also writes h1/h2 for the block's backward),
the max-square target losses in a fused softmax + loss kernel
(``kernels/fused_loss.py``, ``csrc/fused_loss.cu``), and the probe's chain
in ``kernels/matmul_probe.py`` / ``csrc/matmul_probe.cu``.

Entry points run on the card by default: ``device=None`` means ``cuda``
and raises when no card is present (``utils/device.py``). Pass
``device="cpu"`` (``--device cpu``) to run the plain PyTorch versions on
the host.
"""

__version__ = "0.1.0"
