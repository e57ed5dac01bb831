"""The evaluation harness's prediction plug-in (port of the single-device
branch of `tdvnet/eval/harness.py`). The harness's `main`, which walks a
dataset and runs 3D evaluation, arrives with those slices."""
from __future__ import annotations

import os

import numpy as np

from tdvnet_torch.config import Config
from tdvnet_torch.eval.fused_scene import FusedSceneInference


def make_3dvnet_pred_fn(model, cfg: Config):
    """The model's `pred_fn(views, scene_dir, dset)`: whole-scene inference
    through `FusedSceneInference` on the model's device, on the fast path
    when `cfg.eval.fast_path` says so. Result depths are millimetre-quantized
    on fetch (+-0.5 mm, far below every metric threshold)."""
    inf = FusedSceneInference(model, cfg)

    def pred_fn(views, scene_dir, dset):
        out = inf.predict_scene(maybe_drop_u8(views))
        if inf.last_scene_stats:
            print(f"  scene volume stats: {inf.last_scene_stats}")
        return out

    return pred_fn


def maybe_drop_u8(views):
    """With TDVNET_U8_UPLOAD=0 in the environment, normalize u8 images on
    the host and upload floats (4x the image bytes; the same mean/std
    arithmetic in fp32 as the on-device ingest)."""
    if os.environ.get("TDVNET_U8_UPLOAD", "1") != "0" \
            or "images_u8" not in views:
        return views
    views = dict(views)
    u8 = views.pop("images_u8")
    sc = np.float32(views.pop("rgb_scale", 255.0))
    mean = np.asarray(views.pop("rgb_mean"), np.float32)
    std = np.asarray(views.pop("rgb_std"), np.float32)
    views["images"] = ((u8.astype(np.float32) / sc) - mean) / std
    return views
