"""Reference torch checkpoints into the port (counterpart of
dose_prediction_tpu/core/torch_import.py::load_torch_checkpoint, :113-131).

The port's modules carry the reference's module names, so a reference
checkpoint needs only its container unwrapped, its Lightning prefixes
stripped and a ``load_state_dict``; the JAX package's key maps and layout
transposes have no counterpart here.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

# the reference's Lightning wrappers: 'model_.' (the dose trainers'
# self.model_, e.g. HD-UNet's 'model_.model.'), '_model.' (the seg trainer,
# train_light_transeg.py:126-146) and 'model.'; stripped in this order
LIGHTNING_PREFIXES = ("model_.", "_model.", "model.")


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


def strip_lightning_prefixes(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each key without the LIGHTNING_PREFIXES it starts with."""
    out = {}
    for k, v in state_dict.items():
        for prefix in LIGHTNING_PREFIXES:
            if k.startswith(prefix):
                k = k[len(prefix):]
        out[k] = v
    return out


def load_reference_strict(model: torch.nn.Module, state_dict: Mapping[str, torch.Tensor]) -> None:
    """Load a reference state dict (Lightning prefixes stripped) into
    ``model`` strictly: raises ValueError naming the entries that are
    missing, unexpected or of another shape."""
    sd = strip_lightning_prefixes(state_dict)
    mine = model.state_dict()
    missing, extra = sorted(set(mine) - set(sd)), sorted(set(sd) - set(mine))
    bad = [(k, tuple(sd[k].shape), tuple(v.shape)) for k, v in mine.items()
           if k in sd and tuple(sd[k].shape) != tuple(v.shape)]
    if missing or extra or bad:
        raise ValueError(f"the source does not match {type(model).__name__}: "
                         f"{len(missing)} missing {missing[:5]}, {len(extra)} unexpected "
                         f"{extra[:5]}, {len(bad)} of another shape {bad[:5]}")
    model.load_state_dict(sd, strict=True)
