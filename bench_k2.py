#!/usr/bin/env python3
"""Time kernel K2 (instance norm) at every shape a bf16 serve request gives it.

    python3 bench_k2.py [--root DIR]

Imports ``dose_prediction_tpu_torch`` from DIR (default: this checkout), so
that another commit unpacked beside it (``git archive``) is timed on the
same card in the same run. For each of chip_smoke.K2_SHAPES, bfloat16: K2
and ``F.instance_norm`` in ms per call from a CUDA graph of 20 calls
replayed 5 times (chip_smoke.graph_ms), beside the bound (one read and one
write of the volume at 3.35 TB/s). Prints one JSON line per shape, then the
card's name and power limit. Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose port is timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
        return 1
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs

    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch.nn.functional as F

    from dose_prediction_tpu_torch.kernels import instance_norm as k2

    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(cs.SEED)
    for shape in cs.K2_SHAPES:
        x = (torch.randn(shape, generator=g, device=dev) * 2 + 1).bfloat16()
        scale = torch.rand(shape[1], generator=g, device=dev) + 0.5
        bias = torch.randn(shape[1], generator=g, device=dev)
        row = {"root": args.root, "shape": list(shape), "dtype": "bfloat16",
               "graph_ms": cs.graph_ms(lambda: k2.instance_norm_act(x, scale, bias), 20),
               "library_graph_ms": cs.graph_ms(
                   lambda: F.instance_norm(x, weight=scale, bias=bias, eps=1e-5), 20),
               "bound_ms": cs.bound(2 * x.numel() * x.element_size(), 8 * x.numel(),
                                    torch.bfloat16)[0]}
        print(json.dumps(row), flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
