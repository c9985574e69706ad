"""mIoU / pixel-accuracy accounting (port of ``maxsquareloss_tpu/metrics.py``).

The batch update is ``torch.bincount(C*gt + pred)`` over valid pixels on
the tensors' device, in exact int64 counts. The metric math on the
accumulated matrix is the JAX package's host-side numpy ``Eval``, copied.
"""

from __future__ import annotations

import numpy as np
import torch

from maxsquareloss_torch.utils.debug import sync

# SYNTHIA protocol class index sets
SYNTHIA_SET_16 = [0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 11, 12, 13, 15, 17, 18]
SYNTHIA_SET_13 = [0, 1, 2, 6, 7, 8, 10, 11, 12, 13, 15, 17, 18]  # 16 minus {3,4,5}

NAME_CLASSES_19 = [
    "road", "sidewalk", "building", "wall", "fence", "pole",
    "traffic_light", "traffic_sign", "vegetation", "terrain", "sky",
    "person", "rider", "car", "truck", "bus", "train", "motorcycle",
    "bicycle",
]
NAME_CLASSES_13 = [
    "road", "sidewalk", "building", "traffic_light", "traffic_sign",
    "vegetation", "sky", "person", "rider", "car", "bus", "motorcycle",
    "bicycle",
]


def confusion_matrix_update(
    gt: torch.Tensor, pred: torch.Tensor, num_classes: int
) -> torch.Tensor:
    """(C, C) int64 confusion-matrix contribution of one batch.

    rows = ground truth, cols = prediction; pixels with gt outside [0, C)
    (the -1 ignore label) are dropped.
    """
    gt = gt.reshape(-1).long()
    pred = pred.reshape(-1).long()
    valid = (gt >= 0) & (gt < num_classes)
    with sync("confusion_matrix"):  # the mask's and the bincount's sizes come back
        idx = num_classes * gt[valid] + pred[valid]
        counts = torch.bincount(idx, minlength=num_classes**2)
    return counts.reshape(num_classes, num_classes)


class Eval:
    """Host-side metric accounting over an accumulated confusion matrix."""

    def __init__(self, num_class: int):
        self.num_class = num_class
        self.confusion_matrix = np.zeros((num_class, num_class), dtype=np.float64)
        self.ignore_index = None

    def reset(self):
        self.confusion_matrix[:] = 0

    def add_batch(self, gt_image: np.ndarray, pre_image: np.ndarray):
        """numpy path, identical math to the reference's add_batch."""
        assert gt_image.shape == pre_image.shape
        mask = (gt_image >= 0) & (gt_image < self.num_class)
        label = self.num_class * gt_image[mask].astype(np.int64) + pre_image[mask]
        count = np.bincount(label, minlength=self.num_class**2)
        self.confusion_matrix += count.reshape(self.num_class, self.num_class)

    def add_confusion_matrix(self, cm):
        if isinstance(cm, torch.Tensor):
            cm = cm.cpu().numpy()
        self.confusion_matrix += np.asarray(cm, dtype=np.float64)

    # ---- metrics (names follow the reference) ----

    def Pixel_Accuracy(self) -> float:
        cm = self.confusion_matrix
        return float(np.diag(cm).sum() / max(cm.sum(), 1))

    def Mean_Pixel_Accuracy(self) -> float:
        cm = self.confusion_matrix
        with np.errstate(divide="ignore", invalid="ignore"):
            acc = np.diag(cm) / cm.sum(axis=1)
        return float(np.nanmean(acc))

    def _iou_per_class(self) -> np.ndarray:
        cm = self.confusion_matrix
        with np.errstate(divide="ignore", invalid="ignore"):
            iu = np.diag(cm) / (cm.sum(axis=1) + cm.sum(axis=0) - np.diag(cm))
        return iu

    def Mean_Intersection_over_Union(self, class_set: list[int] | None = None) -> float:
        iu = self._iou_per_class()
        if class_set is not None:
            iu = iu[class_set]
        return float(np.nanmean(iu))

    def Mean_Intersection_over_Union_16(self) -> float:
        return self.Mean_Intersection_over_Union(SYNTHIA_SET_16)

    def Mean_Intersection_over_Union_13(self) -> float:
        return self.Mean_Intersection_over_Union(SYNTHIA_SET_13)

    def Frequency_Weighted_Intersection_over_Union(self) -> float:
        cm = self.confusion_matrix
        freq = cm.sum(axis=1) / max(cm.sum(), 1)
        iu = self._iou_per_class()
        valid = freq > 0
        return float((freq[valid] * iu[valid]).sum())

    def Mean_Precision(self) -> float:
        cm = self.confusion_matrix
        with np.errstate(divide="ignore", invalid="ignore"):
            prec = np.diag(cm) / cm.sum(axis=0)
        return float(np.nanmean(prec))

    def Print_Every_class_Eval(self, logger=None, name_classes: list[str] | None = None) -> str:
        """Per-class IoU/precision table (reference's per-class report)."""
        if name_classes is None:
            name_classes = (
                NAME_CLASSES_19 if self.num_class == 19
                else NAME_CLASSES_13 if self.num_class == 13
                else [f"class_{i}" for i in range(self.num_class)]
            )
        iu = self._iou_per_class()
        cm = self.confusion_matrix
        with np.errstate(divide="ignore", invalid="ignore"):
            prec = np.diag(cm) / cm.sum(axis=0)
        lines = [f"{'class':>16s} {'IoU':>8s} {'Precision':>10s}"]
        for i, name in enumerate(name_classes[: self.num_class]):
            iou_s = f"{iu[i]:8.4f}" if not np.isnan(iu[i]) else "     nan"
            pr_s = f"{prec[i]:10.4f}" if not np.isnan(prec[i]) else "       nan"
            lines.append(f"{name:>16s} {iou_s} {pr_s}")
        table = "\n".join(lines)
        if logger is not None:
            logger.info("\n" + table)
        return table
