"""The port's data layer against OpenCV and the JAX package on the same
inputs: the PNG reader and writer and the two resizes of
`tdvnet_torch/data/imageio.py` against `cv2`, the frame selectors, the
scene lists, `Dataset` and the synthetic dataset writer against
`tdvnet/data` and `tools/make_synthetic_dataset.py`."""
import json
import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from _torch_helpers import torch_one_thread  # noqa: F401 (autouse)
from tdvnet_torch.data import imageio

HW = (60, 80)


# ------------------------------------------------------------------- imageio
def _smooth_bgr(h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([127 + 120 * np.sin(xx / 17 + yy / 23),
                    127 + 120 * np.cos(xx / 11 - yy / 7),
                    (xx * yy) % 256], axis=-1)
    return np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("kind", ["bgr8", "depth16", "gray8", "bgra8"])
def test_imageio_reads_png_written_by_cv2(kind, tmp_path):
    rng = np.random.default_rng(1)
    path = str(tmp_path / f"{kind}.png")
    if kind == "depth16":
        img = rng.integers(0, 65535, (48, 64)).astype(np.uint16)
    elif kind == "gray8":
        img = rng.integers(0, 256, (48, 64)).astype(np.uint8)
    elif kind == "bgra8":
        img = rng.integers(0, 256, (48, 64, 4)).astype(np.uint8)
    else:
        img = _smooth_bgr(48, 64)
    assert cv2.imwrite(path, img)
    assert np.array_equal(imageio.imread(path), cv2.imread(path))
    if img.ndim == 2:
        got = imageio.imread_depth(path)
        assert got.dtype == img.dtype
        assert np.array_equal(got, cv2.imread(path, cv2.IMREAD_ANYDEPTH))


def _filter_row(ftype, cur, prior, bpp):
    """PNG filter `ftype` of one row (the encoder's side, written out)."""
    cur, prior = cur.astype(np.int32), prior.astype(np.int32)
    left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
    if ftype == 0:
        pred = np.zeros_like(cur)
    elif ftype == 1:
        pred = left
    elif ftype == 2:
        pred = prior
    elif ftype == 3:
        pred = (left + prior) >> 1
    else:
        p = left + prior - upleft
        pa, pb, pc = (np.abs(p - left), np.abs(p - prior),
                      np.abs(p - upleft))
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, prior, upleft))
    return ((cur - pred) & 0xFF).astype(np.uint8)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_imageio_reads_every_png_filter_type(ftype, tmp_path):
    """Hand-filtered RGB8 and gray16 PNGs, every row with filter `ftype`
    (the rows of one image alternate it with Sub, so each filter also sees a
    prior row that another filter made)."""
    rng = np.random.default_rng(ftype)
    for color, depth, img in (
            (2, 8, rng.integers(0, 256, (9, 7, 3)).astype(np.uint8)),
            (0, 16, rng.integers(0, 65535, (9, 7)).astype(np.uint16))):
        h, w = img.shape[:2]
        raw = np.ascontiguousarray(img.astype(">u2") if depth == 16
                                   else img).view(np.uint8).reshape(h, -1)
        bpp = raw.shape[1] // w
        prior = np.zeros(raw.shape[1], np.uint8)
        body = b""
        for y in range(h):
            f = ftype if y % 2 == 0 else 1
            body += bytes([f]) + _filter_row(f, raw[y], prior, bpp).tobytes()
            prior = raw[y]
        chunk = lambda t, b: (struct.pack(">I", len(b)) + t + b + struct.pack(
            ">I", zlib.crc32(t + b) & 0xFFFFFFFF))
        path = str(tmp_path / f"f{ftype}_{depth}.png")
        with open(path, "wb") as fh:
            fh.write(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                                  color, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(body))
                     + chunk(b"IEND", b""))
        assert np.array_equal(imageio.read_png(path), img)
        assert np.array_equal(imageio.read_png(path),
                              cv2.imread(path, cv2.IMREAD_UNCHANGED)[
                                  ..., ::-1] if depth == 8 else
                              cv2.imread(path, cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("kind", ["bgr8", "bgra8", "gray8", "depth16"])
def test_imageio_write_read_round_trip(kind, tmp_path):
    rng = np.random.default_rng(2)
    shape = {"bgr8": (33, 41, 3), "bgra8": (33, 41, 4), "gray8": (33, 41),
             "depth16": (33, 41)}[kind]
    dtype = np.uint16 if kind == "depth16" else np.uint8
    img = rng.integers(0, np.iinfo(dtype).max, shape).astype(dtype)
    path = str(tmp_path / f"{kind}.png")
    imageio.imwrite(path, img)
    if kind == "bgr8":
        assert np.array_equal(imageio.imread(path), img)
    elif kind == "bgra8":
        assert np.array_equal(imageio.read_png(path), img[..., [2, 1, 0, 3]])
        assert np.array_equal(imageio.imread(path), img[..., :3])
    else:
        got = imageio.imread_depth(path)
        assert got.dtype == img.dtype and np.array_equal(got, img)
    assert np.array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)


def test_imageio_refuses_jpeg(tmp_path):
    path = str(tmp_path / "frame.jpg")
    cv2.imwrite(path, _smooth_bgr(8, 8))
    with pytest.raises(NotImplementedError, match="frame.jpg"):
        imageio.imread(path)
    with pytest.raises(NotImplementedError, match="frame.jpg"):
        imageio.imwrite(path, _smooth_bgr(8, 8))


@pytest.mark.parametrize("src,dst,channels", [
    ((480, 640), (256, 320), 3), ((480, 640), (240, 320), 3),
    ((60, 80), (64, 80), 3), ((61, 83), (100, 121), 1),
    ((48, 64), (30, 37), 3)])
def test_resize_linear_u8_equals_cv2(src, dst, channels):
    img = _smooth_bgr(*src, seed=3)
    if channels == 1:
        img = np.ascontiguousarray(img[..., 0])
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    assert np.array_equal(imageio.resize_linear_u8(img, dst), want)
    want_nn = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_NEAREST)
    assert np.array_equal(imageio.resize_nearest(img, dst), want_nn)


# ------------------------------------------------------------ frame selectors
def _poses(n=40, seed=0):
    from tdvnet_torch.data import synthetic

    return synthetic.make_scene(n, (8, 10), seed=seed,
                                normalize=False)["poses"]


@pytest.mark.parametrize("name,args,seed_idx", [
    ("RangePoseDistSelector", (0.05, 0.3, 10), None),
    ("BestPoseDistSelector", (0.15, 10), None),
    ("NextPoseDistSelector", (0.1, 20), 0),
    ("NeuralReconSelector", (0.1, 15.0), 3),
    ("EveryNthSelector", (3,), None)])
def test_frame_selector_matches_jax(name, args, seed_idx):
    from tdvnet.data import frameselector as J
    from tdvnet_torch.data import frameselector as T

    poses = _poses()
    kw = lambda: ({} if name == "NeuralReconSelector"
                  else {"rng": np.random.default_rng(5)})
    want = getattr(J, name)(*args, **kw()).select_frames(poses, 8, seed_idx)
    got = getattr(T, name)(*args, **kw()).select_frames(poses, 8, seed_idx)
    assert np.array_equal(got, want)
    assert np.array_equal(T.pose_distances(poses[0], poses),
                          J.pose_distances(poses[0], poses))


def test_scenelists_match_jax(tmp_path):
    from tdvnet.data import scenelists as J
    from tdvnet_torch.config import DataConfig
    from tdvnet_torch.data import scenelists as T

    for d in ("b", "a", "c"):
        os.makedirs(tmp_path / d)
        if d != "c":
            (tmp_path / d / "info.json").write_text("{}")
    spec = f"synthetic:{tmp_path}"
    assert T.get_scenes(spec, DataConfig()) == J.get_scenes(spec, None)
    assert T.get_scenes("icl-nuim", DataConfig()) == J.get_scenes(
        "icl-nuim", DataConfig())
    with pytest.raises(ValueError):
        T.get_scenes("nope", DataConfig())


# -------------------------------------------------------------------- dataset
@pytest.fixture(scope="module")
def jax_scene(tmp_path_factory):
    """A 10-view 60x80 scene written by the JAX package's tool (cv2)."""
    from tools.make_synthetic_dataset import make_scene_dir

    root = str(tmp_path_factory.mktemp("jaxscene"))
    return make_scene_dir(root, "synth_0000", n_views=10, hw=HW, seed=0)


@pytest.mark.parametrize("img_size,augment", [
    ((60, 80), False), ((64, 80), False), ((48, 64), True)])
def test_dataset_load_views_matches_jax(jax_scene, img_size, augment):
    """Every key of `load_views` equal to the JAX package's, through a
    resize (bilinear colour, nearest depth) and through the augmentation
    branch with the same random draws; `get_scene_dict`'s and
    `get_whole_scene`'s extras too."""
    from tdvnet.data import dataset as JD, frameselector as JF
    from tdvnet_torch.data import dataset as TD, frameselector as TF

    def make(D, F):
        return D.Dataset([jax_scene], F.NextPoseDistSelector(0.05, 20), None,
                         depth_img_size=(30, 40), img_size=img_size,
                         augment=augment, n_src_on_either_side=1,
                         rng=np.random.default_rng(7))

    jd, td = make(JD, JF), make(TD, TF)
    want, got = jd.load_views(0, seed_idx=0), td.load_views(0, seed_idx=0)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    js, ts = jd.get_scene_dict(0, 0), td.get_scene_dict(0, 0)
    assert np.array_equal(ts["depth_gt"], np.asarray(js["depth_gt"]))
    _, jw = jd.get_whole_scene(0)
    fb, tw = td.get_whole_scene(0)
    assert np.array_equal(tw["depth_gt"], np.asarray(jw["depth_gt"]))
    assert fb.depth_gt is None and fb.n_refs == want["images"].shape[0] - 2


def test_synthetic_dataset_matches_the_jax_tool(jax_scene, tmp_path):
    """The port's writer: the same PNG pixels and info.json as the JAX
    package's tool (cv2), and a GT mesh fused on the port's TSDF within
    0.5% of the tool's vertex count."""
    from tdvnet_torch.data.synthetic_dataset import ensure_scene_dir
    from tdvnet_torch.ops import ply

    d = ensure_scene_dir(str(tmp_path), "synth_0000", 10, HW, 0,
                         device="cpu")
    for sub in ("color", "depth"):
        for i in range(10):
            a = cv2.imread(os.path.join(jax_scene, sub, f"{i:05d}.png"),
                           cv2.IMREAD_UNCHANGED)
            b = cv2.imread(os.path.join(d, sub, f"{i:05d}.png"),
                           cv2.IMREAD_UNCHANGED)
            assert np.array_equal(a, b), (sub, i)
    with open(os.path.join(jax_scene, "info.json")) as f:
        ji = json.load(f)
    with open(os.path.join(d, "info.json")) as f:
        ti = json.load(f)
    assert ti["intrinsics"] == ji["intrinsics"]
    assert [f["pose"] for f in ti["frames"]] == [f["pose"]
                                                 for f in ji["frames"]]
    jv, jf, _ = ply.read_ply(ji["gt_mesh"])
    tv, tf, _ = ply.read_ply(ti["gt_mesh"])
    assert abs(len(tv) - len(jv)) <= 0.005 * len(jv)
    assert abs(len(tf) - len(jf)) <= 0.005 * len(jf)
    assert ensure_scene_dir(str(tmp_path), "synth_0000", 10, HW, 0,
                            device="cpu") == d
