"""A CPU-sized patch of every cell: ResNet stages of 2 blocks and small
maps; the port runs its kernels' plain versions on the CPU."""

SMALL = {
    "config": {"model": {"blocks": [2, 2, 2, 2]},
               "train": {"crop_size": [96, 64], "target_crop_size": [80, 48]},
               "eval": {"base_size": [64, 32], "label_size": [96, 48]}},
    "traffic": {"batch": 2, "pool": 4},
}
CELLS = ("gta5_uda_bf16", "gta5_eval_tta_bf16", "synthia16_uda_fp32", "synthia16_serve_b1_bf16")


def small(dtype: str | None = None) -> dict:
    from portbench.harness import merge

    return merge(SMALL, {"traffic": {"dtype": dtype}}) if dtype else SMALL
