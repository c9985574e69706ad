"""The plain reference of the output check, in plain PyTorch: each
architecture's forward in a file of its own (``deeplabv2.py``), and the
architecture-free parts that take that forward as an argument: the UDA
step with its optimizer (``uda.py``), the evaluation (``evaluate.py``) and
the lower-precision controls (``lowp.py``). It imports nothing of the
program under test and of JAX, and takes nothing the program made."""
