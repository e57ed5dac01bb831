"""Sample a validation split from the ScanNet train scenes (the port of
`tools/make_validation_split.py`, reference
`mv3d/dsets/make_validation_split.py`): `--n` scenes drawn by
`np.random.default_rng(seed).choice`, written sorted by index into
`SPLITS_DIR/<name>.txt`, where `data/scenelists.get_scenes_scannet` reads
named splits; refuses to overwrite.

    python -m tdvnet_torch.tools.make_validation_split \\
        --scannet-dir /data/scannet [--n 100] [--name val_split1]

It reads and writes scene lists and runs nothing on a device, so it takes
no `--device`.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from tdvnet_torch.data.scenelists import get_scenes_scannet

SPLITS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "scannet_splits")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scannet-dir", required=True)
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--name", default="val_split1")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    os.makedirs(SPLITS_DIR, exist_ok=True)
    out = os.path.join(SPLITS_DIR, f"{args.name}.txt")
    if os.path.exists(out):
        raise FileExistsError(f"{out} exists; refusing to overwrite")
    scenes = get_scenes_scannet(args.scannet_dir, "train")
    rng = np.random.default_rng(args.seed)
    pick = rng.choice(len(scenes), size=args.n, replace=False)
    with open(out, "w") as f:
        for i in sorted(pick):
            f.write(os.path.basename(scenes[i]) + "\n")
    print("wrote", out)
    return out


if __name__ == "__main__":
    main()
