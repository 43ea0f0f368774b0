#!/usr/bin/env python3
"""Time kernel K3 (conv3d_k3) in bfloat16 at every shape a serve_k3 request gives it.

    python3 bench_k3.py [--root DIR] [--tiles]

Imports ``dose_prediction_tpu_torch`` from DIR (default: this checkout), so
that another commit unpacked beside it (``git archive``) is timed on the
same card in the same run. For each of chip_smoke.K3_SHAPES, bfloat16, with
chip_smoke.py's seeded inputs: K3 and cuDNN (``F.conv3d`` with the bias
cast to bfloat16, chip_smoke.py's yardstick) in ms per call from a CUDA
graph of 10 calls replayed 5 times (chip_smoke.graph_ms), beside the bound
(chip_smoke.bound: x read and y written once at 3.35 TB/s, or 2·27·C²
operations a voxel at 989 TFLOP/s) and K3's max abs error against
``plain_conv3d_k3``. With ``--tiles``, also every bf16 tile of
``TILES[C]`` that fits, forced in place of ``plan``'s choice: held against
the plain version and timed the same way. Prints one JSON line per shape
(and tile), then the card's name and power limit. Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from unittest import mock

import torch

HERE = Path(__file__).resolve().parent


def time_tiles(cs, k3, x, wt, b, row) -> None:
    """K3 at every tile that fits, each forced in place of the plan."""
    c = x.shape[1]
    want = k3.plain_conv3d_k3(x, wt, b)
    tol = cs.tolerance(want)
    for tile in k3.TILES[c]:
        if k3.smem_bytes(c, tile) > k3.MAX_SMEM:
            continue
        with mock.patch.object(k3, "plan", lambda *args: tile):
            err = (k3.conv3d_k3(x, wt, b).float() - want.float()).abs().max().item()
            ms = cs.graph_ms(lambda: k3.conv3d_k3(x, wt, b), 10)
        print(json.dumps({"shape": row["shape"], "tile": list(tile), "planned":
                          tile == k3.plan(tuple(x.shape)), "graph_ms": ms,
                          "max_abs_err": err, "ok": err <= tol}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose port is timed")
    ap.add_argument("--tiles", action="store_true", help="also time every bf16 tile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
        return 1
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs

    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch.nn.functional as F

    from dose_prediction_tpu_torch.kernels import conv3d as k3

    torch.backends.cudnn.allow_tf32 = False       # the plain version's float32 conv
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(cs.SEED)
    for shape in cs.K3_SHAPES:
        n, c, d, h, w = shape
        x = torch.randn(shape, generator=g, device=dev).bfloat16()
        wt = (torch.rand((c, c, 3, 3, 3), generator=g, device=dev) * 2 - 1) / (27 * c) ** 0.5
        b = torch.randn(c, generator=g, device=dev) * 0.1
        err = (k3.conv3d_k3(x, wt, b).float() - k3.plain_conv3d_k3(x, wt, b).float())
        row = {"root": args.root, "shape": list(shape), "dtype": "bfloat16",
               "graph_ms": cs.graph_ms(lambda: k3.conv3d_k3(x, wt, b), 10),
               "library_graph_ms": cs.graph_ms(
                   lambda: F.conv3d(x, wt.bfloat16(), b.bfloat16(), padding=1), 10),
               "bound_ms": cs.bound(2 * x.numel() * x.element_size(),
                                    2 * n * d * h * w * 27 * c * c, torch.bfloat16)[0],
               "max_abs_err": err.abs().max().item()}
        print(json.dumps(row), flush=True)
        if args.tiles:
            time_tiles(cs, k3, x, wt, b, row)
        del x, err
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
