"""Training entry (the port of `tools/train_3dvnet.py`; reference
`mv3d/train.py` / `mv3d/finetune.py`).

Data comes from `info.json` scenes; with --synthetic N a synthetic dataset
is generated first so the loop runs without real data: N train scenes
(seeds 0..N-1) and 4 unseen validation scenes (seeds 1000..1003), 16 views
each at the batch's image size, cached under the system's temporary
directory in `tdvnet_torch_synth_<N>x16x<h>x<w>/`. Their GT meshes are
fused on the training device, one scene after another.

    python -m tdvnet_torch.tools.train_3dvnet --scannet-dir /data/scannet \\
        --epochs 120
    python -m tdvnet_torch.tools.train_3dvnet --synthetic 8 --epochs 2
    python -m tdvnet_torch.tools.train_3dvnet --finetune --init-from w.npz

`--bf16` trains a bf16 model (its parameters, gradients and Adam's state
fp32), `--remat` recomputes the forward in the backward, and
`--grad-accum K` updates once every K batches with the mean of their
gradients (the schedule counting updates), as the JAX CLI's:

    python -m tdvnet_torch.tools.train_3dvnet --synthetic 2 --epochs 1 \
        --bf16 --remat --grad-accum 2
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from tdvnet_torch.config import load_config, resolve_device

N_VAL_SCENES = 4
SYNTH_VIEWS = 16


def synthetic_scene_dirs(n_train: int, img_size, device):
    """(train dirs, validation dirs) of the --synthetic dataset, written
    first where the cache lacks them."""
    from tdvnet_torch.data.synthetic_dataset import ensure_scene_dir

    h, w = img_size
    root = os.path.join(tempfile.gettempdir(),
                        f"tdvnet_torch_synth_{n_train}x{SYNTH_VIEWS}x{h}x{w}")
    os.makedirs(root, exist_ok=True)
    train = [ensure_scene_dir(root, f"s{i:03d}", SYNTH_VIEWS, img_size, i,
                              device) for i in range(n_train)]
    val = [ensure_scene_dir(root, f"val{i:03d}", SYNTH_VIEWS, img_size,
                            1000 + i, device) for i in range(N_VAL_SCENES)]
    return train, val


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scannet-dir", default=None)
    ap.add_argument("--synthetic", type=int, default=0,
                    help="train on N generated synthetic scenes")
    ap.add_argument("--epochs", type=int, default=120)
    ap.add_argument("--finetune", action="store_true")
    ap.add_argument("--ckpt-dir", default="ckpts/3dvnet")
    ap.add_argument("--log-dir", default="runs/3dvnet")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--init-from", default=None,
                    help="warm-start params from a checkpoint dir or a "
                         ".npz weights file when --ckpt-dir has no "
                         "checkpoint yet (continue a shipped checkpoint "
                         "into a fresh run directory)")
    ap.add_argument("--batch-scenes", type=int, default=2)
    ap.add_argument("--steps-per-epoch", type=int, default=None,
                    help="cap batches per epoch")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 compute (fp32 params/optimizer)")
    ap.add_argument("--remat", action="store_true",
                    help="rematerialize the forward in the backward pass")
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="accumulate gradients over K microbatches "
                         "(effective batch = batch-scenes * K)")
    ap.add_argument("--export-npz", default=None,
                    help="write a committable .npz weight snapshot here "
                         "every --export-every epochs (atomic; survives "
                         "wipes of the checkpoint dir)")
    ap.add_argument("--export-every", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="where to train (default: the CUDA card; 'cpu' "
                         "runs the kernels' plain twins)")
    args = ap.parse_args(argv)

    cfg = load_config({"train": {"finetune": args.finetune,
                                 "bf16_compute": args.bf16,
                                 "remat": args.remat,
                                 "grad_accum_steps": args.grad_accum},
                       "batch": {"n_scenes": args.batch_scenes}})
    if not (args.synthetic or args.scannet_dir):
        ap.error("--scannet-dir or --synthetic required")
    device = resolve_device(args.device)

    from tdvnet_torch.data import scenelists
    from tdvnet_torch.data.dataset import Dataset
    from tdvnet_torch.data.frameselector import (BestPoseDistSelector,
                                                 RangePoseDistSelector)
    from tdvnet_torch.train.loader import StreamingLoader
    from tdvnet_torch.train.loop import fit

    bc = cfg.batch
    if args.synthetic:
        train_dirs, val_dirs = synthetic_scene_dirs(args.synthetic,
                                                    bc.img_size, device)
    else:
        train_dirs = scenelists.get_scenes_scannet(args.scannet_dir, "train")
        val_dirs = scenelists.get_scenes_scannet(args.scannet_dir, "val")

    train_sel = RangePoseDistSelector(0.125, 0.325, cfg.data.img_interval)
    val_sel = BestPoseDistSelector(0.225, cfg.data.img_interval)
    train_dset = Dataset(train_dirs, train_sel, bc.n_ref,
                         depth_img_size=bc.depth_img_size,
                         img_size=bc.img_size, augment=True,
                         n_src_on_either_side=bc.n_src_on_either_side)
    val_dset = Dataset(val_dirs, val_sel, bc.n_ref,
                       depth_img_size=bc.depth_img_size,
                       img_size=bc.img_size, augment=False,
                       n_src_on_either_side=bc.n_src_on_either_side)

    def val_batches(limit=4):
        idx = np.arange(len(val_dset))
        out = []
        for i in range(0, len(idx) - bc.n_scenes + 1, bc.n_scenes):
            out.append(val_dset.get_batch(idx[i:i + bc.n_scenes], bc.n_views,
                                          bc.n_ref))
            if len(out) >= limit:
                break
        return out

    loader = StreamingLoader(train_dset, bc.n_scenes, bc.n_views, bc.n_ref,
                             seed=cfg.train.seed,
                             prefetch=cfg.train.loader_prefetch,
                             workers=cfg.train.loader_workers,
                             steps_per_epoch=args.steps_per_epoch)
    return fit(cfg, loader, val_batches, args.epochs,
               log_dir=args.log_dir, ckpt_dir=args.ckpt_dir,
               resume=args.resume, init_from=args.init_from,
               export_npz=args.export_npz, export_every=args.export_every,
               device=device)


if __name__ == "__main__":
    main()
