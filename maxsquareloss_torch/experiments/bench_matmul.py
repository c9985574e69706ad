"""Calibrate the card's matmul rate at the fused-block matmul shapes.

    python -m maxsquareloss_torch.experiments.bench_matmul [--dtype float32] ...

Counterpart of ``experiments/bench_pallas_matmul.py``, with the same flags
and defaults plus ``--device``: one kernel launch (``kernels.matmul_probe``)
computes a chain of ``relu(y @ A)`` / ``relu(y @ B)`` products per cell of
``x`` (C, M, K), with a row tile of each cell resident in shared memory and
the weights streamed from L2, the fused bottleneck's structure. Its rate
against the card's peak for the type says whether a gap of the fused
bottleneck lies in its inner loop or in its structure.

Inputs come from ``np.random.default_rng(0)`` at scale 0.05, as in the
reference. Each timed call gets a distinct x and a distinct t. On the card
the time is CUDA events over ``--iters`` calls, and the line gives the share
of the H100's peak: 67 TFLOP/s fp32 on the CUDA cores, 989 TFLOP/s bf16
dense on the tensor cores (NVIDIA's data sheet, SXM, 700 W). On the CPU
(``--device cpu``, the plain version) it gives the host time only.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from maxsquareloss_torch.kernels.matmul_probe import matmul_chain
from maxsquareloss_torch.utils.device import resolve_device

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # H100 SXM


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser("bench_matmul")
    ap.add_argument("--m", type=int, default=1728)   # R*Wp at TH=8
    ap.add_argument("--k", type=int, default=1024)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--cells", type=int, default=72)
    ap.add_argument("--chain", type=int, default=3)  # dependent matmuls/cell
    ap.add_argument("--dtype", default="bfloat16", choices=tuple(DTYPES))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out_dtype", default="bfloat16", choices=tuple(DTYPES),
                    help="type each product is cast to before the ReLU")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain version)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    dtype, odtype = DTYPES[args.dtype], DTYPES[args.out_dtype]
    m, k, n, c = args.m, args.k, args.n, args.cells

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(c, m, k)).astype(np.float32) * 0.05).to(device, dtype)
    a = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32) * 0.05).to(device, dtype)
    b = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32) * 0.05).to(device, dtype)

    def tick(i):
        return torch.full((1, 1), 1e-4 * i, dtype=torch.float32, device=device)

    def run(t, xi):
        return matmul_chain(t, xi, a, b, args.chain, odtype)

    # a distinct large operand and scalar for every timed call
    xs = [x + torch.tensor(1e-4 * (i + 1), dtype=dtype, device=device) for i in range(args.iters)]
    ticks = [tick(i) for i in range(args.iters)]
    for i in range(2):
        run(tick(1000 + i), x)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outs = [run(ticks[i], xs[i]) for i in range(args.iters)]
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / args.iters
    else:
        t0 = time.perf_counter()
        outs = [run(ticks[i], xs[i]) for i in range(args.iters)]
        ms = (time.perf_counter() - t0) * 1e3 / args.iters
    flops = 2 * m * k * n * args.chain * c
    tflops = flops / ms / 1e9
    line = (f"M={m} K={k} N={n} chain={args.chain} cells={c} {args.dtype}->"
            f"{args.out_dtype}: {ms:.3f} ms  {tflops:.1f} TF/s")
    result = {"device": str(device), "ms": ms, "tflops": tflops, "flops": flops,
              "out": outs[-1]}
    if device.type == "cuda":
        share = flops / (ms * 1e-3) / PEAK_FLOPS[dtype]
        line += (f" ({100 * share:.1f}% of the H100's {PEAK_FLOPS[dtype] / 1e12:.0f} TFLOP/s "
                 f"{args.dtype} peak; {torch.cuda.get_device_name(0)})")
        result["peak_share"] = share
    else:
        line += f" (plain version on {device})"
    print(line, flush=True)
    return result


if __name__ == "__main__":
    main()
