"""Reference torch checkpoints into the port (counterpart of
dose_prediction_tpu/core/torch_import.py::load_torch_checkpoint, :113-131).

The port's modules carry the reference's module names, so a reference
checkpoint needs only its container unwrapped and a strict
``load_state_dict``; the JAX package's key maps and layout transposes have
no counterpart here.
"""

from __future__ import annotations

from typing import Dict

import torch


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A flat {name: tensor} state dict from a reference checkpoint: the
    NetworkTrainer format ({'network_state_dict': ...},
    network_trainer.py:349-356), Lightning ({'state_dict': ...}) or a bare
    state dict, with DataParallel 'module.' prefixes stripped (:341-344).

    The file is unpickled in full (``weights_only=False``, as the JAX
    loader does: Lightning and NetworkTrainer files carry more than
    tensors), so load only checkpoints from a source you trust."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict):
        for key in ("network_state_dict", "state_dict"):
            if key in obj:
                obj = obj[key]
                break
    out = {}
    for k, v in obj.items():
        if k.startswith("module."):
            k = k[len("module."):]
        out[k] = v.detach().cpu() if torch.is_tensor(v) else torch.as_tensor(v)
    return out
