"""DVH curves and slice-error figures (counterpart of
dose_prediction_tpu/evaluation/plots.py:22-89; reference plot_DVH,
evaluate_openKBP.py:225-314, and the GT/pred/error slice triptychs of
train_light_pyfer.py:222-263).

matplotlib is imported when a figure is drawn, never with this module. Where
it is not installed (the card's machine has none) drawing raises
``PlotsUnavailable``: asking for plots never passes silently.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

from dose_prediction_tpu_torch.evaluation.metrics import STRUCTURE_NAMES

DVH_BINS = 5000
DVH_MAX_GY = 90.0


class PlotsUnavailable(RuntimeError):
    """matplotlib is not installed, so no figure can be written."""


def pyplot():
    """matplotlib.pyplot on the Agg backend, or PlotsUnavailable."""
    try:
        import matplotlib
    except ImportError as e:
        raise PlotsUnavailable(
            "--plots-dir needs matplotlib, which is not installed in this "
            "environment; run without --plots-dir, or where matplotlib is "
            "installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def cumulative_dvh(dose: np.ndarray, roi_mask: np.ndarray,
                   *, bins: int = DVH_BINS, max_gy: float = DVH_MAX_GY) -> np.ndarray:
    """Volume fraction above each dose on the reference's binning
    (evaluate_openKBP.py:238-296): a histogram over [-inv, max), then
    1 − cumsum."""
    inv = max_gy / bins
    edges = np.arange(-1, bins) * inv
    roi_dose = dose.reshape(-1)[roi_mask.reshape(-1) > 0]
    hist, _ = np.histogram(roi_dose, edges)
    c = np.cumsum(hist)
    if c[-1] == 0:
        return np.zeros(bins)
    return 1.0 - c / c.max()


def plot_dvh(pred: np.ndarray, gt: np.ndarray, structures: Dict[str, np.ndarray],
             path: str | Path, *, dpi: int = 300) -> None:
    """Write the per-patient DVH comparison figure: reference solid,
    prediction dashed, one colour per structure."""
    plt = pyplot()
    import matplotlib.colors as mcolors

    inv = DVH_MAX_GY / DVH_BINS
    x = np.arange(0, DVH_BINS) * inv
    colors = list(mcolors.TABLEAU_COLORS.values())
    fig = plt.figure(dpi=150)
    legend_handles = []
    for i, name in enumerate(STRUCTURE_NAMES):
        roi = structures.get(name)
        if roi is None or not np.any(roi):
            continue
        color = colors[i % len(colors)]
        line, = plt.plot(x, cumulative_dvh(gt, roi) * 100, color=color, linewidth=2,
                         label=name)
        plt.plot(x, cumulative_dvh(pred, roi) * 100, color=color, linewidth=2,
                 linestyle="dashed")
        legend_handles.append(line)
    plt.ylabel("volume %")
    plt.xlabel("dose (Gy)")
    plt.legend(handles=legend_handles, bbox_to_anchor=(1.1, 1.05), prop={"size": 6})
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=dpi, bbox_inches="tight")
    plt.close(fig)


def save_slice_triptychs(pred_gy: np.ndarray, gt_gy: np.ndarray, out_dir: str | Path,
                         *, axis: int = 0, every: int = 1) -> None:
    """GT / prediction / |error| jet-colormap jpgs, one per slice
    (train_light_pyfer.py:235-263)."""
    plt = pyplot()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for i in range(0, pred_gy.shape[axis], every):
        p = np.take(pred_gy, i, axis=axis)
        g = np.take(gt_gy, i, axis=axis)
        fig, axs = plt.subplots(3, 1, figsize=(4, 10))
        plt.subplots_adjust(wspace=0, hspace=0)
        for ax, img in zip(axs, (g, p, np.abs(g - p))):
            ax.imshow(img, cmap="jet")
            ax.axis("off")
        fig.savefig(out_dir / f"{i}.jpg", bbox_inches="tight")
        plt.close(fig)
