"""Reference torch checkpoints into the port (counterpart of
dose_prediction_tpu/core/torch_import.py::load_torch_checkpoint, :113-131).

The port's modules carry the reference's module names, so a reference
checkpoint needs only its container unwrapped, its Lightning prefixes
stripped and a ``load_state_dict``; the JAX package's key maps and layout
transposes have no counterpart here.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import torch

# the reference's Lightning wrappers: 'model_.' (the dose trainers'
# self.model_, e.g. HD-UNet's 'model_.model.'), '_model.' (the seg trainer,
# train_light_transeg.py:126-146) and 'model.'; stripped in this order
LIGHTNING_PREFIXES = ("model_.", "_model.", "model.")
# a combined DoseGAN checkpoint's generator and critic entries
# (torch_import.py:544-656 honours the same prefixes)
GAN_PREFIXES = {"g": ("netG.", "generator."), "d": ("netD.", "discriminator.")}


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


def strip_lightning_prefixes(state_dict: Mapping[str, torch.Tensor],
                             prefixes: Sequence[str] = LIGHTNING_PREFIXES
                             ) -> Dict[str, torch.Tensor]:
    """Each key without the ``prefixes`` it starts with, in their order."""
    out = {}
    for k, v in state_dict.items():
        for prefix in prefixes:
            if k.startswith(prefix):
                k = k[len(prefix):]
        out[k] = v
    return out


# the ViT generator's Lightning wrappers: the exp model's 'model_.'
# (train_light_exp_models.py:118) and ViT-GAN's 'generator.'
# (train_light_gan.py:124); the critic's entries and the reference's unused
# 'out' head (MainSubsetModel.out, never called) have no counterpart
VIT_GENERATOR_PREFIXES = ("model_.", "generator.")


def vit_generator_part(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A reference ViT generator's entries (torch_import.py:284-311): its
    Lightning prefix stripped, a combined GAN checkpoint's critic entries
    and the unused ``out`` head left out."""
    out = {}
    for k, v in state_dict.items():
        for prefix in VIT_GENERATOR_PREFIXES:
            if k.startswith(prefix):
                k = k[len(prefix):]
                break
        else:
            if k.startswith("discriminator."):
                continue
        if not k.startswith("out."):
            out[k] = v
    return out


def gan_part(state_dict: Mapping[str, torch.Tensor], part: str) -> Dict[str, torch.Tensor]:
    """The generator's (``part='g'``) or the critic's (``'d'``) entries of a
    reference DoseGAN checkpoint: from a combined checkpoint the entries
    under GAN_PREFIXES[part], prefix stripped (the other net's are left
    out); a bare net's state dict as it is."""
    prefixes = GAN_PREFIXES[part]
    if not any(k.startswith(p) for k in state_dict for ps in GAN_PREFIXES.values() for p in ps):
        return dict(state_dict)
    return {k[len(p):]: v for k, v in state_dict.items() for p in prefixes if k.startswith(p)}


def load_reference_strict(model: torch.nn.Module, state_dict: Mapping[str, torch.Tensor], *,
                          prefixes: Sequence[str] = LIGHTNING_PREFIXES) -> None:
    """Load a reference state dict, ``prefixes`` stripped (the Lightning
    wrappers by default; DoseGAN's nets name their own top module ``model``,
    so their callers pass none), into ``model`` strictly: raises ValueError
    naming the entries that are missing, unexpected or of another shape."""
    sd = strip_lightning_prefixes(state_dict, prefixes)
    mine = model.state_dict()
    missing, extra = sorted(set(mine) - set(sd)), sorted(set(sd) - set(mine))
    bad = [(k, tuple(sd[k].shape), tuple(v.shape)) for k, v in mine.items()
           if k in sd and tuple(sd[k].shape) != tuple(v.shape)]
    if missing or extra or bad:
        raise ValueError(f"the source does not match {type(model).__name__}: "
                         f"{len(missing)} missing {missing[:5]}, {len(extra)} unexpected "
                         f"{extra[:5]}, {len(bad)} of another shape {bad[:5]}")
    model.load_state_dict(sd, strict=True)
