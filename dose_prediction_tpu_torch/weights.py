"""Carry JAX variables of the JAX package's models into the port's modules.

``jax_to_torch(variables, model)`` maps the flax variable tree of
``DosePyfer`` (either decoder block, ``multiS_conv``), ``TranSeg`` (every
block family, both k7 modes, both decoder blocks and patch embeds),
``CascadeC3D``, ``UNETR``, ``HDUNet``, DoseGAN's ``UnetGenerator3D`` and
``NLayerDiscriminator`` or a model of the experiments zoo
({'params': ..., 'batch_stats': ...}, nested dicts of numpy arrays) onto
``model``'s state dict: every entry of the state dict must come from the
tree and every leaf of the tree must be used, or it raises. The port's
module names are the reference torch names. Two mechanisms name the flax
path of a port module:

- a walk down the module tree (``walk_key_map``) for DOSE-PYFER, the C3D
  cascade and the zoo (``WALKED_MODELS``): each block class names its
  children as the JAX block does, every other module keeps its own name;
- regular expressions on the module key (``transeg_key_map`` /
  ``unetr_key_map`` / ``hdunet_key_map`` / ``dosegan_g_key_map`` /
  ``dosegan_d_key_map``, the inverse of
  dose_prediction_tpu/core/torch_import.py's maps of those names) for the
  models the walk does not cover: its rules would need TranSeg's separable
  chains flattened (``conv0_d``), a head named by the model (``out/conv``
  in TranSeg, ``out`` in UNETR) and HD-UNet's and DoseGAN's renamed levels.

The port keeps its own copy of those maps (for the module names the port
builds, the separable chains and the ablation DualDilatedBlock's BatchNorm
fuse among them, which no reference checkpoint holds) and of the layout
rules. A weight is transposed as a ConvTranspose3d's wherever the module
holding it is one.

- Conv3d (O, I, k..) ↔ flax (k.., I, O); ConvTranspose3d (I, O, k..) ↔
  (k.., I, O); Linear (O, I) ↔ (I, O);
- norm weight ↔ scale; BatchNorm running_mean/var ↔ batch_stats mean/var;
  ViT position_embeddings ↔ pos_embedding.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from torch import nn

from dose_prediction_tpu_torch.models import (
    UNETR,
    CascadeC3D,
    DosePyfer,
    HDUNet,
    NLayerDiscriminator,
    TranSeg,
    UnetGenerator3D,
)
from dose_prediction_tpu_torch.models import c3d as _c3d
from dose_prediction_tpu_torch.models import dose_pyfer as _pyfer
from dose_prediction_tpu_torch.models import experiments as _exp
from dose_prediction_tpu_torch.nn import blocks as _blocks
from dose_prediction_tpu_torch.nn import mdunet as _md
from dose_prediction_tpu_torch.nn import unetr as _unetr
from dose_prediction_tpu_torch.nn import vit as _vit

Path = Tuple[str, ...]


def _res_block_path(prefix: Path, tail: str) -> Optional[Path]:
    """conv{1,2,3}.conv / norm{1,2,3} of a UnetResBlock → flax names (convs
    named, norms flax-auto-numbered InstanceNorm_{0,1,2})."""
    m = re.match(r"^conv(\d)\.conv$", tail)
    if m:
        return prefix + (f"conv{m[1]}",)
    m = re.match(r"^norm(\d)$", tail)
    if m:
        return prefix + (f"InstanceNorm_{int(m[1]) - 1}",)
    return None


# the ViT trunk and the UnetrBasicBlock / UnetrPrUpBlock skip encoders;
# {enc1}/{enc} name them ('skip1'/'skip' in DOSE-PYFER, 'encoder1'/'encoder'
# in TranSeg)
_VIT_PATTERNS = [
    (r"^vit\.patch_embedding\.patch_embeddings(?:\.1)?$",     # perceptron or conv embed
     lambda m: ("vit", "patch_embedding", "proj")),
    (r"^vit\.patch_embedding$", lambda m: ("vit", "patch_embedding")),
    (r"^vit\.blocks\.(\d+)\.(norm1|norm2)$", lambda m: ("vit", f"block{m[1]}", m[2])),
    (r"^vit\.blocks\.(\d+)\.attn\.(qkv|out_proj)$",
     lambda m: ("vit", f"block{m[1]}", "attn", m[2])),
    (r"^vit\.blocks\.(\d+)\.mlp\.(linear1|linear2)$",
     lambda m: ("vit", f"block{m[1]}", "mlp", m[2])),
    (r"^vit\.norm$", lambda m: ("vit", "norm")),
]
_SKIP_PATTERNS = [
    (r"^({enc1})\.layer\.(.+)$", lambda m: _res_block_path((m[1], "layer"), m[2])),
    (r"^({enc}[234])\.transp_conv_init\.conv$", lambda m: (m[1], "transp_conv_init")),
    (r"^({enc}[234])\.blocks\.(\d+)\.0\.conv$", lambda m: (m[1], f"up{m[2]}")),
    (r"^({enc}[234])\.blocks\.(\d+)\.1\.(.+)$",
     lambda m: _res_block_path((m[1], f"block{m[2]}"), m[3])),
]
# ModifiedUnetrUpBlock stages: Conv31 or DualDilatedBlock of any family.
# A branch conv_{3,5,7} is Sequential-wrapped ('.0.', the seg and ablation
# Conv31) or bare; its ConvBlockK holds convs at .conv.{0,3} (a separable
# chain's 1-D convs below them as d/h/w) and norms at .conv.{1,4}; the fuse
# is Sequential-wrapped ('.0', BatchNorm at '.1' in the ablation
# DualDilatedBlock) or bare.
_DECODER_PATTERNS = [
    (r"^({dec})\.transp_conv\.conv$", lambda m: (m[1], "transp_conv")),
    (r"^({dec})\.conv_block\.cov_\.conv_([357])(?:\.0)?\.conv\.([03])$",
     lambda m: (m[1], "conv_block", f"branch{m[2]}", f"conv{int(m[3]) // 3}")),
    (r"^({dec})\.conv_block\.cov_\.conv_([357])(?:\.0)?\.conv\.([03])\.([dhw])$",
     lambda m: (m[1], "conv_block", f"branch{m[2]}", f"conv{int(m[3]) // 3}_{m[4]}")),
    (r"^({dec})\.conv_block\.cov_\.conv_([357])(?:\.0)?\.conv\.([14])$",
     lambda m: (m[1], "conv_block", f"branch{m[2]}", f"norm{int(m[3]) // 4}")),
    (r"^({dec})\.conv_block\.cov_\.conv(?:\.0)?$", lambda m: (m[1], "conv_block", "fuse")),
    (r"^({dec})\.conv_block\.cov_\.conv\.1$", lambda m: (m[1], "conv_block", "fuse_norm")),
]
# UnetrUpBlock stages of the plain UNETR (UnetResBlock or UnetBasicBlock)
_UNETR_DECODER_PATTERNS = [
    (r"^({dec})\.transp_conv\.conv$", lambda m: (m[1], "transp_conv")),
    (r"^({dec})\.conv_block\.(.+)$", lambda m: _res_block_path((m[1], "conv_block"), m[2])),
]
_HDUNET_PATTERNS = [
    (re.compile(r"^encoder\.encoder_1\.(\d)\.single_conv\.([01])$"),
     lambda m: (f"enc1_c{int(m[1]) + 1}", "conv", "conv" if m[2] == "0" else "norm")),
    (re.compile(r"^encoder\.encoder_([2-5])\.(\d)\.single_conv\.([01])$"),
     lambda m: ((f"enc{m[1]}_down" if m[2] == "0" else f"enc{m[1]}_c{m[2]}"), "conv",
                "conv" if m[3] == "0" else "norm")),
    (re.compile(r"^decoder\.upconv_(\d)\.conv\.([01])$"),
     lambda m: (f"upconv_{m[1]}", "conv", "conv" if m[2] == "0" else "norm")),
    (re.compile(r"^decoder\.decoder_conv_(\d)\.(\d)\.single_conv\.([01])$"),
     lambda m: (f"dec{m[1]}_c{int(m[2]) + 1}", "conv" if m[3] == "0" else "norm")),
    (re.compile(r"^decoder\.final_conv$"), lambda m: ("final_conv",)),
]


def _compile(patterns, **names):
    return [(re.compile(p.format(**names)), build) for p, build in patterns]


def _under(prefix: str, patterns):
    """The patterns, matched below ``prefix.`` and mapped below ``(prefix,)``."""
    def wrap(build):
        def path(m):
            inner = build(m)
            return None if inner is None else (prefix,) + inner
        return path
    return [(rf"^{prefix}\." + p[1:], wrap(b)) for p, b in patterns]


_TRANSEG = _compile(
    _VIT_PATTERNS + _SKIP_PATTERNS + _DECODER_PATTERNS
    + [(r"^out\.conv\.conv$", lambda m: ("out", "conv"))],
    enc1="encoder1", enc="encoder", dec=r"decoder[2-5]")


_UNETR = _compile(
    _VIT_PATTERNS + _SKIP_PATTERNS + _UNETR_DECODER_PATTERNS
    + [(r"^out\.conv\.conv$", lambda m: ("out",))],
    enc1="encoder1", enc="encoder", dec=r"decoder[2-5]")


def _match(patterns, key: str) -> Optional[Path]:
    for pattern, build in patterns:
        m = pattern.match(key)
        if m:
            return build(m)
    return None


def transeg_key_map(module_key: str) -> Optional[Path]:
    """Port (= reference) module key of TranSeg → flax path."""
    return _match(_TRANSEG, module_key)


def unetr_key_map(module_key: str) -> Optional[Path]:
    """Port (= reference) module key of UNETR → flax path."""
    return _match(_UNETR, module_key)


def hdunet_key_map(module_key: str) -> Optional[Path]:
    """Port (= reference) module key of HDUNet → flax path."""
    return _match(_HDUNET_PATTERNS, module_key)


# DoseGAN (torch_import.py:544-640): each generator level at
# model(.model.3)^depth, its Sequential's 1 = downconv, 2 = downnorm, 5 =
# upconv, 6 = upnorm (3 = upconv, 4 = upnorm at the innermost level, which
# has no downnorm and no submodule); the critic's blocks at model.3-5
_GAN_G_LEVEL = re.compile(r"^model((?:\.model\.3)*)"
                          r"\.(att_gate\.(?:initial_conv|intermediate\.[12])|model\.[1-6])$")
_GAN_G_LEAF = {1: "downconv", 2: "downnorm", 3: "upconv", 4: "upnorm", 5: "upconv", 6: "upnorm"}
_GAN_ATT_LEAF = {"initial_conv": "initial_conv", "1": "inter_conv", "2": "inter_norm"}
_GAN_G_BARE = {"initial_block.0": ("initial_conv",), "initial_block.1": ("initial_norm",),
               "outer_block.0": ("outer_conv",)}
_GAN_D_BARE = {"model.0": ("initial_conv",), "model.1": ("initial_norm",),
               "model.6": ("final_conv",), "model.7": ("final_norm",)}
_GAN_D_BLOCK = re.compile(r"^model\.([3-5])\.(downsample\.[01]|pooling\.[01]"
                          r"|att_gate\.(?:initial_conv|intermediate\.[12]))$")
_GAN_D_LEAF = {"downsample.0": "down_conv", "downsample.1": "down_norm",
               "pooling.0": "pool_conv", "pooling.1": "pool_norm"}


def _att_gate_path(tail: str) -> Path:
    return ("att_gate", _GAN_ATT_LEAF[tail.rsplit(".", 1)[-1]])


def dosegan_g_key_map(module_key: str) -> Optional[Path]:
    """Port (= reference) module key of UnetGenerator3D → flax path."""
    if module_key in _GAN_G_BARE:
        return _GAN_G_BARE[module_key]
    m = _GAN_G_LEVEL.match(module_key)
    if m is None:
        return None
    level = ("unet",) + ("submodule",) * m[1].count(".model.3")
    if m[2].startswith("att_gate"):
        return level + _att_gate_path(m[2])
    return level + (_GAN_G_LEAF[int(m[2].rsplit(".", 1)[-1])],)


def dosegan_d_key_map(module_key: str) -> Optional[Path]:
    """Port (= reference) module key of NLayerDiscriminator (three blocks)
    → flax path."""
    if module_key in _GAN_D_BARE:
        return _GAN_D_BARE[module_key]
    m = _GAN_D_BLOCK.match(module_key)
    if m is None:
        return None
    block = (f"block{int(m[1]) - 3}",)
    if m[2].startswith("att_gate"):
        return block + _att_gate_path(m[2])
    return block + (_GAN_D_LEAF[m[2]],)


# -- DOSE-PYFER, the C3D cascade and the experiments zoo: a walk down the
# module tree ------------------------------------------------------------------
# Each rule takes a module and the remaining components of a key below it,
# and returns (flax names, components consumed) or None; the walk goes on
# in the child the consumed components name. A module without a rule keeps
# its child's name.

def _single_conv(_, parts):         # SingleConv: single_conv.{0: conv, 1: norm}
    if parts[:1] == ["single_conv"] and parts[1:2] in (["0"], ["1"]):
        return ("conv" if parts[1] == "0" else "norm",), 2
    return None


def _up_conv(_, parts):             # UpConv: conv.{0, 1} → conv/{conv, norm}
    if parts[:1] == ["conv"] and parts[1:2] in (["0"], ["1"]):
        return ("conv", "conv" if parts[1] == "0" else "norm"), 2
    return None


def _conv_block_k(_, parts):        # ConvBlockK: conv.{0, 3} convs, {1, 4} norms
    leaf = {"0": "conv0", "1": "norm0", "3": "conv1", "4": "norm1"}
    if parts[:1] == ["conv"] and len(parts) > 1 and parts[1] in leaf:
        return (leaf[parts[1]],), 2
    return None


def _multi_scale(module, parts):    # Conv31 / DualDilatedBlock
    m = re.match(r"^conv_([357])$", parts[0])
    if m:
        wrapped = isinstance(getattr(module, parts[0]), nn.Sequential)
        return (f"branch{m[1]}",), 2 if wrapped else 1
    if parts[0] == "conv":
        if isinstance(module.conv, nn.Sequential):     # a fuse stage with its norm
            return ("fuse" if parts[1] == "0" else "fuse_norm",), 2
        return ("fuse",), 1
    return None


def _res_block(_, parts):           # UnetResBlock / UnetBasicBlock
    path = _res_block_path((), ".".join(parts[:2]) if parts[1:2] == ["conv"] else parts[0])
    return (path, 2 if parts[1:2] == ["conv"] else 1) if path else None


def _pr_up_block(_, parts):         # UnetrPrUpBlock
    if parts[:2] == ["transp_conv_init", "conv"]:
        return ("transp_conv_init",), 2
    if parts[:1] == ["blocks"] and parts[2:3] == ["0"]:
        return (f"up{parts[1]}",), 4
    if parts[:1] == ["blocks"] and parts[2:3] == ["1"]:
        return (f"block{parts[1]}",), 3
    return None


def _up_block(_, parts):            # UnetrUpBlock / ModifiedUnetrUpBlock
    if parts[:2] == ["transp_conv", "conv"]:
        return ("transp_conv",), 2
    return None


def _vit_walk(_, parts):            # the ViT trunk: the regular patterns, whole
    path = _match(_compile(_VIT_PATTERNS), "vit." + ".".join(parts))
    return (path[1:], len(parts)) if path else None


def _c3d_encoder(_, parts):         # encoder_L.S → encoder_L_conv{S+1}
    return (f"{parts[0]}_conv{int(parts[1]) + 1}",), 2


def _c3d_decoder(_, parts):         # decoder_conv_L.S → decoder_L_conv{S+1}
    m = re.match(r"^decoder_conv_(\d)$", parts[0])
    return ((f"decoder_{m[1]}_conv{int(parts[1]) + 1}",), 2) if m else None


def _dose_convertors(_, parts):     # dose_convertors.{i}.0 → dose_convertor{i}
    if parts[:1] == ["dose_convertors"]:
        return (f"dose_convertor{parts[1]}",), 3
    return None


def _resnet(_, parts):              # MedicalNet names → ResNet3D's
    if parts[0] in ("conv1", "bn1"):
        return ("stem" if parts[0] == "conv1" else "stem_bn",), 1
    m = re.match(r"^layer(\d)$", parts[0])
    if m:
        return (f"stage{int(m[1]) - 1}_block{parts[1]}",), 2
    return None


def _res_block3d(_, parts):         # downsample.{0: conv, 1: BatchNorm}
    if parts[:1] == ["downsample"]:
        return ("downsample" if parts[1] == "0" else "bn_down",), 2
    return None


_WALK_RULES = {
    _blocks.SingleConv: _single_conv, _blocks.UpConv: _up_conv,
    _md.ConvBlockK: _conv_block_k, _md.Conv31: _multi_scale,
    _md.DualDilatedBlock: _multi_scale,
    _md.MultiUnetBasicBlock: lambda _, parts: ((), 1) if parts[0] == "cov_" else None,
    _unetr.UnetResBlock: _res_block, _unetr.UnetBasicBlock: _res_block,
    _unetr.UnetrPrUpBlock: _pr_up_block, _unetr.UnetrUpBlock: _up_block,
    _unetr.ModifiedUnetrUpBlock: _up_block, _vit.ViT: _vit_walk,
    _c3d.Encoder: _c3d_encoder, _c3d.Decoder: _c3d_decoder,
    _pyfer.MainSubsetModel: _dose_convertors, _exp.VitGenerator: _dose_convertors,
    _exp.ResNet3D: _resnet,
    _exp.ResBlock3D: _res_block3d,
}
WALKED_MODELS = (DosePyfer, CascadeC3D, _exp.VitGenerator, _exp.ResNet3D,
                 _exp.SharedEncoderModel, _exp.ExperimentalCascade, _exp.SharedUNetModel,
                 _exp.SharedUNetRModelA, _exp.SharedUNetRModel, _exp.ModelMonai)


def walk_key_map(model: nn.Module, module_key: str) -> Optional[Path]:
    """Port module key of a model of ``WALKED_MODELS`` (or of any module
    built of their blocks) → flax path."""
    parts, module, path = module_key.split("."), model, ()
    while parts:
        rule = _WALK_RULES.get(type(module))
        found = rule(module, parts) if rule else None
        names, used = found if found else ((parts[0],), 1)
        for name in parts[:used]:
            module = getattr(module, name, None) if module is not None else None
        path, parts = path + tuple(names), parts[used:]
    return path


_KEY_MAPS: Dict[type, Callable[[str], Optional[Path]]] = {
    TranSeg: transeg_key_map,
    UNETR: unetr_key_map,
    HDUNet: hdunet_key_map,
    UnetGenerator3D: dosegan_g_key_map,
    NLayerDiscriminator: dosegan_d_key_map,
}
# torch leaf → (flax collection, flax leaf); 'weight' depends on rank
_LEAVES = {
    "bias": ("params", "bias"),
    "running_mean": ("batch_stats", "mean"),
    "running_var": ("batch_stats", "var"),
    "position_embeddings": ("params", "pos_embedding"),
}


def _to_torch_layout(value: np.ndarray, ndim: int, transposed: bool) -> np.ndarray:
    if ndim == 5:   # (k.., I, O) → (I, O, k..) transposed, (O, I, k..) otherwise
        return value.transpose(3, 4, 0, 1, 2) if transposed else value.transpose(4, 3, 0, 1, 2)
    if ndim == 2:   # (I, O) → (O, I)
        return value.T
    return value


def _leaves(tree: Mapping, prefix: Path = ()) -> Dict[Path, Any]:
    out: Dict[Path, Any] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def jax_to_torch(variables: Mapping, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """State dict for ``model`` (a model of ``WALKED_MODELS`` or a TranSeg,
    UNETR, HDUNet, UnetGenerator3D or NLayerDiscriminator) from the JAX
    package's
    variables of the same configuration. Raises if an entry of the
    state dict has no source, a shape differs, or a JAX leaf is left over;
    the result loads with ``model.load_state_dict(sd, strict=True)``."""
    if isinstance(model, WALKED_MODELS):
        key_map = lambda key: walk_key_map(model, key)  # noqa: E731
    else:
        key_map = _KEY_MAPS[type(model)]
    source = _leaves({c: variables.get(c, {}) for c in ("params", "batch_stats")})
    used = set()
    state: Dict[str, torch.Tensor] = {}
    for key, ref in model.state_dict().items():
        module_key, leaf = key.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            state[key] = torch.zeros_like(ref, device="cpu")
            continue
        path = key_map(module_key)
        if path is None:
            raise ValueError(f"no JAX counterpart for {key}")
        if leaf == "weight":
            collection, flax_leaf = "params", ("kernel" if ref.ndim > 1 else "scale")
        else:
            collection, flax_leaf = _LEAVES[leaf]
        src = (collection,) + path + (flax_leaf,)
        if src not in source:
            raise ValueError(f"{key}: JAX leaf {'/'.join(src)} not found")
        transposed = isinstance(model.get_submodule(module_key), nn.ConvTranspose3d)
        value = _to_torch_layout(np.asarray(source[src]), ref.ndim, transposed)
        if tuple(value.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: shape {tuple(value.shape)} from {'/'.join(src)}, "
                             f"want {tuple(ref.shape)}")
        state[key] = torch.from_numpy(np.ascontiguousarray(value)).to(ref.dtype)
        used.add(src)
    unused = sorted("/".join(p) for p in source if p not in used)
    if unused:
        raise ValueError(f"{len(unused)} JAX leaves have no port counterpart: {unused[:5]}")
    return state
