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
  LR (``optim.py``).
The 29 stride-1 identity bottlenecks of ResNet-101 run in one fused CUDA
kernel each (``kernels/fused_block.py``, ``csrc/fused_bottleneck.cu``;
with grad enabled the kernel also writes h1/h2 for the block's backward),
and the max-square target losses in a fused softmax + loss kernel
(``kernels/fused_loss.py``, ``csrc/fused_loss.cu``).

Entry points run on the card by default: ``device=None`` means ``cuda``
and raises when no card is present (``utils/device.py``). Pass
``device="cpu"`` to run the plain PyTorch versions on the host.
"""

__version__ = "0.1.0"
