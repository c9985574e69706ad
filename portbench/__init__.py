"""The benchmark of the PyTorch/CUDA port ``maxsquareloss_torch``: one
command runs one cell (``python3 portbench/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>``); see ``harness.py``."""
