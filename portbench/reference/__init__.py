"""The plain reference of the output check: DeepLabV2-ResNet101, the UDA
step with SGD, and the evaluation, in plain PyTorch. It imports nothing of
the program under test and of JAX, and takes nothing the program made."""
