"""Export the port's checkpoint directory (or an `.npz`) to the committable
single-file `.npz` (the port of `tools/export_weights.py`): params and
batch_stats only, floats as fp16, in the JAX package's layout, so the file
loads in both packages.

    python -m tdvnet_torch.tools.export_weights --ckpt-dir ckpts/3dvnet \\
        --out weights/3dvnet.npz

It reads and writes files and runs nothing on a device, so it takes no
`--device`.
"""
from __future__ import annotations

import argparse
import os

from tdvnet_torch.train import checkpoints as C


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    restored = C.restore_params(args.ckpt_dir)
    if restored is None:
        raise FileNotFoundError(f"no checkpoint in {args.ckpt_dir}")
    variables, ep = restored
    path = C.export_npz(args.out, variables, epoch=ep)
    print(f"epoch {ep} -> {path} "
          f"({os.path.getsize(path) / 1e6:.1f} MB)")
    return path


if __name__ == "__main__":
    main()
