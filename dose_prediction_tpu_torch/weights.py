"""Carry JAX variables of the JAX package's models into the port's modules.

``jax_to_torch(variables, model)`` maps the flax variable tree of
``DosePyfer`` (either decoder block, ``multiS_conv``), ``TranSeg`` (every
block family, both k7 modes, both decoder blocks and patch embeds),
``CascadeC3D``, ``UNETR``, ``HDUNet`` or DoseGAN's ``UnetGenerator3D`` and
``NLayerDiscriminator``
({'params': ..., 'batch_stats': ...}, nested dicts of numpy arrays) onto
``model``'s state dict: every entry of the state dict must come from the
tree and every leaf of the tree must be used, or it raises. The port's
module names are the reference torch names, so the key maps are the
inverse of dose_prediction_tpu/core/torch_import.py's ``pyfer_key_map`` /
``transeg_key_map`` / ``c3d_key_map`` / ``unetr_key_map`` /
``hdunet_key_map`` / ``dosegan_g_key_map`` / ``dosegan_d_key_map``; the
port keeps its own copy of those maps (for the module names the port builds, the separable chains and the ablation
DualDilatedBlock's BatchNorm fuse among them, which no reference
checkpoint holds) and of the layout rules:

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

from dose_prediction_tpu_torch.models import (
    UNETR,
    CascadeC3D,
    DosePyfer,
    HDUNet,
    NLayerDiscriminator,
    TranSeg,
    UnetGenerator3D,
)

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


def _c3d_path(key: str) -> Optional[Path]:
    for pattern, build in _C3D_PATTERNS:
        m = pattern.match(key)
        if m:
            return build(m)
    return None


# net_A of DOSE-PYFER, net_A and net_B of the C3D cascade
_C3D_PATTERNS = [
    (re.compile(r"^(net_[AB])\.encoder\.encoder_(\d)\.(\d)\.single_conv\.([01])$"),
     lambda m: (m[1], "encoder", f"encoder_{m[2]}_conv{int(m[3]) + 1}",
                "conv" if m[4] == "0" else "norm")),
    (re.compile(r"^(net_[AB])\.decoder\.decoder_conv_(\d)\.(\d)\.single_conv\.([01])$"),
     lambda m: (m[1], "decoder", f"decoder_{m[2]}_conv{int(m[3]) + 1}",
                "conv" if m[4] == "0" else "norm")),
    (re.compile(r"^(net_[AB])\.decoder\.upconv_(\d)\.conv\.([01])$"),
     lambda m: (m[1], "decoder", f"upconv_{m[2]}", "conv", "conv" if m[3] == "0" else "norm")),
    (re.compile(r"^(conv_out_[AB])$"), lambda m: (m[1],)),
]

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


_PYFER_NETB = _compile(
    _under("encoder", _VIT_PATTERNS + _SKIP_PATTERNS) + _under("decoder", _DECODER_PATTERNS)
    + [(r"^dose_convertors\.(\d)\.0$", lambda m: (f"dose_convertor{m[1]}",))],
    enc1="skip1", enc="skip", dec=r"decoder[1-4]")

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


def pyfer_key_map(module_key: str) -> Optional[Path]:
    """Port (= reference) module key of DosePyfer → flax path."""
    if module_key.startswith("net_B."):
        path = _match(_PYFER_NETB, module_key[len("net_B."):])
        return None if path is None else ("net_B",) + path
    return _c3d_path(module_key)


def transeg_key_map(module_key: str) -> Optional[Path]:
    """Port (= reference) module key of TranSeg → flax path."""
    return _match(_TRANSEG, module_key)


def c3d_key_map(module_key: str) -> Optional[Path]:
    """Port (= reference) module key of CascadeC3D → flax path."""
    return _c3d_path(module_key)


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


def is_transposed(module_key: str) -> bool:
    """Modules holding ConvTranspose3d weights: the UnetrPrUpBlock chains and
    the decoder transposed convs."""
    return bool(re.search(r"(transp_conv|transp_conv_init)\.conv$", module_key)
                or re.search(r"\.blocks\.\d+\.0\.conv$", module_key))


_KEY_MAPS: Dict[type, Callable[[str], Optional[Path]]] = {
    DosePyfer: pyfer_key_map,
    TranSeg: transeg_key_map,
    CascadeC3D: c3d_key_map,
    UNETR: unetr_key_map,
    HDUNet: hdunet_key_map,
    UnetGenerator3D: dosegan_g_key_map,
    NLayerDiscriminator: dosegan_d_key_map,
}
# which modules hold ConvTranspose3d weights, by model type
_TRANSPOSED: Dict[type, Callable[[str], bool]] = {
    UnetGenerator3D: lambda key: (dosegan_g_key_map(key) or ("",))[-1] == "upconv",
    NLayerDiscriminator: lambda key: False,
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
    """State dict for ``model`` (a DosePyfer, TranSeg, CascadeC3D, UNETR,
    HDUNet, UnetGenerator3D or NLayerDiscriminator) from the JAX package's
    variables of the same configuration. Raises if an entry of the
    state dict has no source, a shape differs, or a JAX leaf is left over;
    the result loads with ``model.load_state_dict(sd, strict=True)``."""
    key_map = _KEY_MAPS[type(model)]
    transposed = _TRANSPOSED.get(type(model), is_transposed)
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
        value = _to_torch_layout(np.asarray(source[src]), ref.ndim, transposed(module_key))
        if tuple(value.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: shape {tuple(value.shape)} from {'/'.join(src)}, "
                             f"want {tuple(ref.shape)}")
        state[key] = torch.from_numpy(np.ascontiguousarray(value)).to(ref.dtype)
        used.add(src)
    unused = sorted("/".join(p) for p in source if p not in used)
    if unused:
        raise ValueError(f"{len(unused)} JAX leaves have no port counterpart: {unused[:5]}")
    return state
