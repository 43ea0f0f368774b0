"""3D Vision Transformer with hidden-state taps (counterpart of
dose_prediction_tpu/nn/vit.py; MONAI 0.7 ViT semantics).

- Perceptron patch embed: non-overlapping patches, token order (gD, gH, gW),
  features within a patch in (pd, ph, pw, c) order with c last, then a
  Linear; or the 'conv' patch embed, a Conv3d with kernel = stride = patch
  whose output is flattened in the same token order. Learned position
  embeddings for the trained token grid, resized trilinearly to the input's
  grid where it differs (``trained_grid``).
- Pre-norm blocks: x += attn(ln(x)); x += mlp(ln(x)). QKV is one bias-free
  Linear whose output axis is (qkv, heads, head_dim); attention runs
  through kernel K1's wrapper, or, with ``DPT_PALLAS_ATTENTION=0``
  (core/config.py), through its plain version ``plain_attention``, the
  counterpart of the JAX einsum route; the MLP is Linear → exact
  GELU → Linear.
- Returns the final LayerNorm'd tokens and the hidden states after each
  block (before the final norm).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from dose_prediction_tpu_torch import ops
from dose_prediction_tpu_torch.core.config import FLAGS
from dose_prediction_tpu_torch.kernels import attention as k1
from dose_prediction_tpu_torch.nn.layers import Conv3d, LayerNorm, Linear


def patchify(x: torch.Tensor, patch: int) -> torch.Tensor:
    """(N, C, D, H, W) → (N, tokens, patch³·C), token order (gD, gH, gW),
    feature order (pd, ph, pw, c) — the reference's Rearrange
    'b c (h p1) (w p2) (d p3) -> b (h w d) (p1 p2 p3 c)'."""
    n, c, d, h, w = x.shape
    gd, gh, gw = d // patch, h // patch, w // patch
    x = x.reshape(n, c, gd, patch, gh, patch, gw, patch)
    x = x.permute(0, 2, 4, 6, 3, 5, 7, 1)
    return x.reshape(n, gd * gh * gw, patch ** 3 * c)


def tokens_to_volume(tokens: torch.Tensor, grid: Sequence[int]) -> torch.Tensor:
    """(N, tokens, hidden) → (N, hidden, gD, gH, gW) — the reference's
    proj_feat (dose_pyfer.py:118-122)."""
    n, l, hidden = tokens.shape
    if l != grid[0] * grid[1] * grid[2]:
        raise ValueError(f"token count {l} != grid {tuple(grid)}")
    return tokens.reshape(n, *grid, hidden).permute(0, 4, 1, 2, 3).contiguous()


class Patchify(nn.Module):
    """The parameter-free Rearrange slot of the reference's patch_embeddings."""

    def __init__(self, patch: int):
        super().__init__()
        self.patch = patch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return patchify(x, self.patch)


class PatchEmbeddingBlock(nn.Module):
    """Patches → Linear (``pos_embed='perceptron'``) or a patch-strided
    Conv3d (``'conv'``, JAX nn/vit.py:109-137), plus learned position
    embeddings for the token grid they were trained on: ``trained_grid``,
    or else the grid of ``img_size`` (an int or a (D, H, W) triple). The
    input's own grid is taken at each call; where it differs from
    ``trained_grid``, the embeddings are resized to it trilinearly
    (align_corners=True), as the JAX PatchEmbed3D does
    (dose_prediction_tpu/nn/vit.py:110-148). Without ``trained_grid`` the
    input must have the grid of ``img_size``."""

    def __init__(self, in_ch: int, img_size, patch: int, hidden: int, trained_grid=None,
                 pos_embed: str = "perceptron"):
        super().__init__()
        img = (img_size,) * 3 if isinstance(img_size, int) else tuple(img_size)
        self.patch = patch
        self.trained_grid = tuple(int(g) for g in trained_grid) if trained_grid else None
        self.base_grid = self.trained_grid or tuple(int(s) // patch for s in img)
        if pos_embed == "perceptron":
            self.patch_embeddings = nn.Sequential(Patchify(patch),
                                                  Linear(in_ch * patch ** 3, hidden))
        elif pos_embed == "conv":
            self.patch_embeddings = Conv3d(in_ch, hidden, patch, stride=patch)
        else:
            raise ValueError(f"unknown pos_embed {pos_embed!r} (want 'perceptron' or 'conv')")
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, self.base_grid[0] * self.base_grid[1] * self.base_grid[2], hidden))

    def grid(self, x: torch.Tensor) -> Tuple[int, int, int]:
        """The token grid of an ``(N, C, D, H, W)`` input."""
        return tuple(int(s) // self.patch for s in x.shape[2:])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tokens = self.patch_embeddings(x)
        if tokens.ndim == 5:          # the conv embed: (N, hidden, gD, gH, gW)
            tokens = tokens.flatten(2).transpose(1, 2)
        grid = self.grid(x)
        pos = self.position_embeddings
        if grid != self.base_grid:
            if self.trained_grid is None:
                raise ValueError(f"input token grid {grid}, but the position embedding was "
                                 f"made for {self.base_grid} (pass trained_grid to resize it)")
            hidden = pos.shape[-1]
            pos = ops.resize3d(pos.reshape(1, *self.base_grid, hidden).permute(0, 4, 1, 2, 3),
                               grid, mode="trilinear", align_corners=True)
            pos = pos.permute(0, 2, 3, 4, 1).reshape(1, tokens.shape[1], hidden)
        return tokens + pos.to(tokens.dtype)


class SABlock(nn.Module):
    """Multi-head self-attention (MONAI SABlock)."""

    def __init__(self, hidden: int, heads: int):
        super().__init__()
        if hidden % heads:
            raise ValueError(f"hidden {hidden} not divisible by heads {heads}")
        self.heads = heads
        self.out_proj = Linear(hidden, hidden)
        self.qkv = Linear(hidden, hidden * 3, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, l, hidden = x.shape
        qkv = self.qkv(x).reshape(n, l, 3, self.heads, hidden // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)      # each (N, heads, L, Dh)
        out = (k1.fused_attention if FLAGS.use_k1_attention else k1.plain_attention)(q, k, v)
        return self.out_proj(out.transpose(1, 2).reshape(n, l, hidden))


class MLPBlock(nn.Module):
    def __init__(self, hidden: int, mlp_dim: int):
        super().__init__()
        self.linear1 = Linear(hidden, mlp_dim)
        self.linear2 = Linear(mlp_dim, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(ops.gelu(self.linear1(x)))


class TransformerBlock(nn.Module):
    def __init__(self, hidden: int, mlp_dim: int, heads: int):
        super().__init__()
        self.mlp = MLPBlock(hidden, mlp_dim)
        self.norm1 = LayerNorm(hidden)
        self.attn = SABlock(hidden, heads)
        self.norm2 = LayerNorm(hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ViT(nn.Module):
    """Returns (final_normed_tokens, [hidden states after each block]);
    ``grid(x)`` is the token grid (gD, gH, gW) of an input."""

    def __init__(self, in_ch: int, img_size, patch: int = 16,
                 hidden: int = 768, mlp_dim: int = 3072, num_layers: int = 12,
                 heads: int = 12, trained_grid=None, pos_embed: str = "perceptron"):
        super().__init__()
        self.patch_embedding = PatchEmbeddingBlock(in_ch, img_size, patch, hidden, trained_grid,
                                                   pos_embed)
        self.blocks = nn.ModuleList(
            [TransformerBlock(hidden, mlp_dim, heads) for _ in range(num_layers)])
        self.norm = LayerNorm(hidden)

    def grid(self, x: torch.Tensor) -> Tuple[int, int, int]:
        return self.patch_embedding.grid(x)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        x = self.patch_embedding(x)
        hidden_states = []
        for blk in self.blocks:
            x = blk(x)
            hidden_states.append(x)
        return self.norm(x), hidden_states
