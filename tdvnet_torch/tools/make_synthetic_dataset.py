"""Write synthetic `info.json` scenes that exercise the real data pipeline
(the port of `tools/make_synthetic_dataset.py`): PNG colour, 16-bit PNG
depth in millimetres, poses and a GT mesh TSDF-fused from the GT depths on
the device (`data/synthetic_dataset.make_scene_dir`). Scene s is
`synth_<s:04d>`, drawn from seed s.

    python -m tdvnet_torch.tools.make_synthetic_dataset --dst /tmp/synth \\
        --scenes 2 --views 24 [--hw 240 320] [--device cpu]
"""
from __future__ import annotations

import argparse
import os

from tdvnet_torch.config import resolve_device
from tdvnet_torch.data.synthetic_dataset import make_scene_dir


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dst", required=True)
    ap.add_argument("--scenes", type=int, default=2)
    ap.add_argument("--views", type=int, default=24)
    ap.add_argument("--hw", type=int, nargs=2, default=(240, 320))
    ap.add_argument("--device", default=None,
                    help="where the GT meshes are fused (default: the CUDA "
                         "card; 'cpu' runs the kernels' plain twins)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.dst, exist_ok=True)
    dirs = []
    for s in range(args.scenes):
        d = make_scene_dir(args.dst, f"synth_{s:04d}", args.views, args.hw,
                           s, device)
        print("wrote", d)
        dirs.append(d)
    return dirs


if __name__ == "__main__":
    main()
