"""Building blocks as torch ``nn.Module``s with the reference's module names:
leaf layers, C3D blocks, the seg-family multi-scale conv block, the UNETR
block family and the 3D ViT."""
