"""Scene list resolution per dataset (copy of `tdvnet/data/scenelists.py`;
reference `mv3d/dsets/scenelists.py`).

ScanNet scenes come from the official split txts (scans_test for 'test');
ICL-NUIM uses the 4 paper scenes, TUM-RGBD the 10 paper sequences.
"""
from __future__ import annotations

import os
from typing import List

ICL_NUIM_SCENES = [
    "living_room_traj1_frei_png",
    "living_room_traj2_frei_png",
    "traj1_frei_png",
    "traj2_frei_png",
]

TUM_RGBD_SCENES = [
    "rgbd_dataset_freiburg1_desk",
    "rgbd_dataset_freiburg1_plant",
    "rgbd_dataset_freiburg1_room",
    "rgbd_dataset_freiburg1_teddy",
    "rgbd_dataset_freiburg2_desk",
    "rgbd_dataset_freiburg2_dishes",
    "rgbd_dataset_freiburg3_cabinet",
    "rgbd_dataset_freiburg3_long_office_household",
    "rgbd_dataset_freiburg3_structure_notexture_far",
    "rgbd_dataset_freiburg3_structure_texture_far",
]


def get_scenes_scannet(scannet_dir: str, split: str = "train") -> List[str]:
    scans = os.path.join(scannet_dir,
                         "scans_test" if split == "test" else "scans")
    if split in ("train", "val", "test"):
        split_txt = os.path.join(scannet_dir, f"scannetv2_{split}.txt")
    else:
        split_txt = os.path.join(os.path.dirname(__file__), "scannet_splits",
                                 f"{split}.txt")
    with open(split_txt) as f:
        return [os.path.join(scans, line.strip()) for line in f
                if line.strip()]


def get_scenes_icl_nuim(icl_dir: str) -> List[str]:
    return [os.path.join(icl_dir, s) for s in ICL_NUIM_SCENES]


def get_scenes_tum_rgbd(tum_dir: str) -> List[str]:
    return [os.path.join(tum_dir, s) for s in TUM_RGBD_SCENES]


def get_scenes_synthetic(root: str) -> List[str]:
    """Any directory of `info.json` scene folders (synthetic/test data)."""
    return sorted(os.path.join(root, d) for d in os.listdir(root)
                  if os.path.isdir(os.path.join(root, d))
                  and os.path.exists(os.path.join(root, d, "info.json")))


def get_scenes(dataset_type: str, data_cfg) -> List[str]:
    if dataset_type == "scannet":
        return sorted(get_scenes_scannet(data_cfg.scannet_dir, "test"))
    if dataset_type == "scannet_val":
        return sorted(get_scenes_scannet(data_cfg.scannet_dir, "val"))
    if dataset_type == "icl-nuim":
        return sorted(get_scenes_icl_nuim(data_cfg.icl_nuim_dir))
    if dataset_type == "tum-rgbd":
        return sorted(get_scenes_tum_rgbd(data_cfg.tum_rgbd_dir))
    if dataset_type.startswith("synthetic:"):
        return get_scenes_synthetic(dataset_type.split(":", 1)[1])
    raise ValueError(f"unknown dataset type {dataset_type!r}")
