"""K-fold cross-validation (counterpart of dose_prediction_tpu/train/kfold.py).

Reference DosePrediction/Train/k_fold_train_light_pyfer.py: 6 folds by
monai CrossValidation over the training patients (seed 123456, :333-341);
each fold trains a fresh DOSE-PYFER and can resume from its own checkpoint
directory (:344-379).
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from dose_prediction_tpu_torch.data.openkbp import OpenKBPDataset


def kfold_split(n_items: int, n_folds: int = 6, *, seed: int = 123456
                ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(train_idx, val_idx) of each fold, monai ``CrossValidation``'s folds
    bit for bit (k_fold_train_light_pyfer.py:336-341): ``range(n)`` shuffled
    in place by the legacy ``np.random.RandomState(seed)``, partition i =
    ``indices[i::n_folds]`` (by stride, not in contiguous chunks); fold f
    validates on partition f and trains on the others in partition order
    (``folds[0:f] + folds[f+1:]``, :346-348)."""
    indices = np.arange(n_items)
    np.random.RandomState(seed).shuffle(indices)
    parts = [indices[i::n_folds] for i in range(n_folds)]
    return [(np.concatenate([parts[j] for j in range(n_folds) if j != i]), parts[i])
            for i in range(n_folds)]


class _Subset:
    """An index view over an OpenKBPDataset (it shares the base's cache)."""

    def __init__(self, base: OpenKBPDataset, indices: Sequence[int]):
        self._base = base
        self._idx = [int(i) for i in indices]
        self.patients = [base.patients[i] for i in self._idx]

    def __len__(self):
        return len(self._idx)

    def __getitem__(self, i):
        return self._base[self._idx[i]]


def run_kfold(dataset: OpenKBPDataset, make_trainer: Callable[[int, str], object], *,
              n_folds: int = 6, seed: int = 123456, start_fold: int = 0,
              base_dir: str = "kfold") -> Dict[int, Dict]:
    """Train each fold from ``start_fold`` on (the loop's resume point,
    :344) with ``make_trainer(fold, base_dir/fold_<fold>)``, which must have
    ``fit(train_ds, val_ds)`` and may have ``test(val_ds)``; {fold: test
    results}."""
    results: Dict[int, Dict] = {}
    splits = kfold_split(len(dataset), n_folds, seed=seed)
    for fold in range(start_fold, n_folds):
        train_idx, val_idx = splits[fold]
        trainer = make_trainer(fold, str(Path(base_dir) / f"fold_{fold}"))
        val_ds = _Subset(dataset, val_idx)
        trainer.fit(_Subset(dataset, train_idx), val_ds)
        results[fold] = trainer.test(val_ds) if hasattr(trainer, "test") else {}
    return results
