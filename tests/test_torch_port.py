"""The port's ground rules and its foundation modules against the JAX
package: no JAX in the port, device rules, config, synthetic data, batch
collation, camera ops, sampling, 2D metrics."""
import ast
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import n, t
from _torch_helpers import torch_one_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "optax", "tdvnet")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "tdvnet_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_source_imports_no_jax_and_no_tdvnet():
    files = _port_files()
    assert len(files) > 20
    bad = [(os.path.relpath(f, ROOT), m) for f in files
           for m in _imported_roots(f) if m in FORBIDDEN]
    assert not bad, bad


def test_port_imports_with_jax_absent():
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'optax', 'tdvnet'):\n"
        "    sys.modules[m] = None\n"
        "import tdvnet_torch, tdvnet_torch.weights, chip_smoke\n"
        "import tdvnet_torch.models.threedvnet, tdvnet_torch.eval.metrics2d\n"
        "import tdvnet_torch.kernels.build\n"
        "from tdvnet_torch.config import ModelConfig\n"
        "from tdvnet_torch.models.threedvnet import ThreeDVNet\n"
        "ThreeDVNet(ModelConfig())\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_entry_without_device_raises_without_card(monkeypatch):
    from tdvnet_torch.config import resolve_device
    from tdvnet_torch.weights import load_threedvnet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_threedvnet(os.path.join(ROOT, "weights", "3dvnet_synth48.npz"))
    assert resolve_device("cpu") == torch.device("cpu")


def test_wrappers_run_their_twin_on_cpu_and_count_nothing():
    from tdvnet_torch import kernels as K
    from tdvnet_torch.kernels.propagation import propagation_blend_ref
    from tdvnet_torch.kernels.softargmax import softargmax_depth_ref
    from tdvnet_torch.kernels.trilinear import trilinear_sample_ref
    from tdvnet_torch.kernels.variance import source_variance_ref

    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    K.reset_launch_counts()
    feats, pts = r(3, 6, 7, 4), r(2, 5, 3) + torch.tensor([0.0, 0.0, 3.0])
    sidx = torch.tensor([[0, 1], [1, 2]])
    smask = torch.tensor([[True, True], [True, False]])
    P_all = torch.cat([torch.eye(3).expand(3, 3, 3) * 5,
                       torch.zeros(3, 3, 1)], -1)
    args = (pts, feats, sidx, smask, P_all, (24, 28))
    assert torch.equal(K.source_variance(*args), source_variance_ref(*args))
    grid, q = r(2, 4, 5, 6, 8), r(2, 9, 3)
    c0 = r(2, 3)
    out = torch.zeros(2, 9, 12)
    K.trilinear_sample(grid, q, c0, 0.5, out, 4)
    assert torch.equal(out[..., 4:], trilinear_sample_ref(grid, q, c0, 0.5))
    assert not out[..., :4].any()
    lg, d = r(2, 5, 6, 9), r(2, 5, 6)
    assert torch.equal(K.propagation_blend(lg, d), propagation_blend_ref(lg, d))
    cost, dv = r(2, 8, 3, 4), torch.linspace(0.5, 2.0, 8)
    assert torch.equal(K.softargmax_depth(cost, dv),
                       softargmax_depth_ref(cost, dv))

    from tdvnet_torch.kernels.groupnorm import masked_group_norm_ref
    from tdvnet_torch.kernels.segmax import gather_concat_ref, segment_max_ref
    from tdvnet_torch.kernels.voxelize import (scatter_anchors_to_dense_ref,
                                               voxelize_ref)

    pts3 = torch.rand(200, 3, generator=g) * 1.5 - 0.1
    scene = torch.arange(200) // 100
    valid = torch.rand(200, generator=g) > 0.1
    vargs = (pts3, scene, valid, 0.08, (16, 16, 16), 64, 2)
    va, vb = K.voxelize_points(*vargs), voxelize_ref(*vargs)
    assert all(torch.equal(a, b) for a, b in zip(va, vb))
    assert va.order is not None            # the twin keeps the sorted view
    af = r(64, 8)
    for a, b in zip(K.scatter_anchors_to_dense(af, va, (16, 16, 16), 2),
                    scatter_anchors_to_dense_ref(af, vb, (16, 16, 16), 2)):
        assert torch.equal(a, b)
    y = r(200, 8)
    pa = K.segment_max(y, va.point2anchor, va.point_valid, 65)
    assert torch.equal(pa, segment_max_ref(y, va.point2anchor,
                                           va.point_valid, 65))
    assert torch.equal(K.gather_concat(y, pa, va.point2anchor, relu=True),
                       gather_concat_ref(y, pa, va.point2anchor, relu=True))
    x, m = r(2, 8, 3, 4, 5), (torch.rand(2, 1, 3, 4, 5, generator=g) > 0.5).float()
    w, b = r(8), r(8)
    for kw in ({}, {"relu": True}, {"skip": r(2, 8, 3, 4, 5)}):
        assert torch.equal(K.masked_group_norm(x, m, 4, w, b, **kw),
                           masked_group_norm_ref(x, m, 4, w, b, **kw))
    from tdvnet_torch.kernels.patchfan import patch_fan_variance_ref
    from tdvnet_torch.kernels.trilinear import trilinear_sample_i8_ref

    qg = torch.randint(-127, 128, (2, 4, 5, 6, 8), generator=g,
                       dtype=torch.int8)
    sc = torch.rand(2, 8, generator=g)
    out = torch.zeros(2, 9, 12, dtype=torch.bfloat16)
    K.trilinear_sample_i8(qg, sc, q, c0, 0.5, out, 4, cell_offset=1.0)
    assert torch.equal(out[..., 4:],
                       trilinear_sample_i8_ref(qg, sc, q, c0, 0.5, 1.0))
    assert not out[..., :4].any()
    fan = r(2, 7, 5, 3) * 0.2 + torch.tensor([0.0, 0.0, 3.0])
    args = (fan, feats, sidx, smask, P_all, (24, 28))
    assert torch.equal(K.patch_fan_variance(*args),
                       patch_fan_variance_ref(*args))
    from tdvnet_torch.kernels.fusion import camera_table, consistency_fuse_ref
    from tdvnet_torch.kernels.tsdf import tsdf_integrate_ref

    depths, colors = r(3, 6, 7).abs() + 1, r(3, 6, 7, 3)
    targs = (depths, colors, P_all, torch.tensor([-1.0, -1.0, 0.5]),
             (5, 4, 6), 0.3)
    for a, b in zip(K.tsdf_integrate(*targs), tsdf_integrate_ref(*targs)):
        assert torch.equal(a, b)
    Kc = torch.tensor([[5.0, 0, 3], [0, 5, 3], [0, 0, 1]]).expand(3, 3, 3)
    cams = camera_table(Kc, torch.eye(3).expand(3, 3, 3),
                        torch.tensor([[0.0, 0, 0], [0.1, 0, 0], [0, 0.1, 0]]))
    fargs = (depths[:2], depths, cams, torch.tensor([0, 1]), 0.5, 1)
    for a, b in zip(K.consistency_fuse(*fargs), consistency_fuse_ref(*fargs)):
        assert torch.equal(a, b)
    assert len(K.launch_counts()) == 13
    assert all(v == 0 for v in K.launch_counts().values())


def test_wrappers_refuse_tensors_off_cpu_and_cuda():
    from tdvnet_torch import kernels as K

    cost = torch.empty(2, 8, 3, 4, device="meta")
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        K.softargmax_depth(cost, torch.empty(8, device="meta"))
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        K.propagation_blend(torch.empty(2, 5, 6, 9), torch.empty(
            2, 5, 6, device="meta"))
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        K.segment_max(torch.empty(5, 4), torch.empty(5, dtype=torch.int64),
                      torch.empty(5, dtype=torch.bool, device="meta"), 3)
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        K.masked_group_norm(torch.empty(1, 4, 2, 2, 2, device="meta"),
                            torch.empty(1, 1, 2, 2, 2), 2, torch.empty(4),
                            torch.empty(4))


def test_config_matches_jax_defaults_and_refuses_matmul_warp():
    from tdvnet.config import BatchConfig as JBatch, ModelConfig as JModel
    from tdvnet_torch.config import BatchConfig, ModelConfig, \
        tiny_test_config
    from tdvnet.config import tiny_test_config as jax_tiny

    skip = ("dtype", "warp_mode", "warp_alpha_max", "conv3d_impl")
    strip = lambda m: {k: v for k, v in dataclasses.asdict(m).items()
                       if k not in skip}
    assert strip(ModelConfig()) == strip(JModel())
    assert dataclasses.asdict(BatchConfig()) == dataclasses.asdict(JBatch())
    assert strip(tiny_test_config().model) == strip(jax_tiny().model)
    assert dataclasses.asdict(tiny_test_config().batch) == \
        dataclasses.asdict(jax_tiny().batch)
    assert ModelConfig().warp_mode == "gather"
    assert ModelConfig().dtype == torch.float32
    with pytest.raises(ValueError, match="gather"):
        ModelConfig(warp_mode="matmul")


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_scenes_are_bit_identical(seed):
    from tdvnet.data import synthetic as J
    from tdvnet_torch.data import synthetic as T

    a, b = J.make_scene(9, (48, 60), seed), T.make_scene(9, (48, 60), seed)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    # depth kept at another size goes through the nearest resize
    a = J.make_batch_scene(5, (48, 60), (24, 45), seed)
    b = T.make_batch_scene(5, (48, 60), (24, 45), seed)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_collate_matches_jax():
    from tdvnet.data import batch as JB
    from tdvnet_torch.data import batch as TB
    from tdvnet_torch.data import synthetic

    # a short scene exercises the padding of views and ref slots
    scenes = [synthetic.make_batch_scene(9, (32, 40), (32, 40), 0),
              synthetic.make_batch_scene(5, (32, 40), (32, 40), 1)]
    a, b = JB.collate_scenes(scenes, 9, 7, 1), TB.collate_scenes(scenes, 9, 7, 1)
    assert a.n_scenes == b.n_scenes == 2
    for f in dataclasses.fields(b):
        if f.name != "n_scenes":
            np.testing.assert_array_equal(np.asarray(getattr(a, f.name)),
                                          n(getattr(b, f.name)), f.name)
    sc = scenes[0]
    a = JB.single_scene_views(sc["images"], sc["rotmats"], sc["tvecs"],
                              sc["K"], None, 1)
    b = TB.single_scene_views(sc["images"], sc["rotmats"], sc["tvecs"],
                              sc["K"], None, 1)
    for name in ("ref_idx", "src_idx", "src_mask", "ref_mask", "img_scene"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      n(getattr(b, name)))
    assert b.to("cpu").images.shape == (9, 32, 40, 3)


def test_camera_ops_match_jax():
    from tdvnet.ops import camera as J
    from tdvnet_torch.ops import camera as T
    from tdvnet_torch.data import synthetic

    sc = synthetic.make_scene(4, (64, 80), seed=2)
    K, R, tv = sc["K"], sc["rotmats"], sc["tvecs"]
    # geometry in fp32: a few ulps of ~100-pixel coordinates
    tol = dict(rtol=1e-5, atol=1e-4)
    # bit-equal to linspace as the jitted model compiles it
    for a, b, num in ((0.5, 5.25, 96), (0.0, 319.0, 56), (0.5, 1.25, 16)):
        np.testing.assert_array_equal(
            np.asarray(jax.jit(lambda: jnp.linspace(a, b, num,
                                                    dtype=jnp.float32))()),
            n(T.linspace_f32(a, b, num)))
    np.testing.assert_array_equal(np.asarray(J.build_img_grid((64, 80), (16, 20))),
                                  n(T.build_img_grid((64, 80), (16, 20))))
    Pj = J.projection_matrix(K, R, tv)
    Pt = T.projection_matrix(t(K), t(R), t(tv))
    np.testing.assert_allclose(np.asarray(Pj), n(Pt), **tol)
    rng = np.random.default_rng(0)
    # include points behind and beside the camera (|z| and z<0)
    pts = rng.normal(0, 2, (4, 50, 3)).astype(np.float32)
    xyj, zj = J.project_points(pts, Pj)
    xyt, zt = T.project_points(t(pts), Pt)
    np.testing.assert_allclose(np.asarray(zj), n(zt), **tol)
    np.testing.assert_allclose(np.asarray(xyj), n(xyt), rtol=1e-4, atol=1e-3)
    depth = rng.uniform(0.5, 4, (4, 8, 10)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(J.backproject_grid(depth, K, R, tv, (64, 80))),
        n(T.backproject_grid(t(depth), t(K), t(R), t(tv), (64, 80))), **tol)
    np.testing.assert_allclose(
        np.asarray(J.plane_sweep_points(0.5, 0.1, 6, R, tv, K, (64, 80),
                                        (8, 10))),
        n(T.plane_sweep_points(0.5, 0.1, 6, t(R), t(tv), t(K), (64, 80),
                               (8, 10))), **tol)
    np.testing.assert_allclose(np.asarray(J.camera_center(R, tv)),
                               n(T.camera_center(t(R), t(tv))), **tol)
    Rj, tj = J.world_to_cam(sc["poses"])
    Rt, tt = T.world_to_cam(t(sc["poses"]))
    np.testing.assert_allclose(np.asarray(Rj), n(Rt), **tol)
    np.testing.assert_allclose(np.asarray(tj), n(tt), **tol)
    xy = rng.uniform(0, 79, (7, 2)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(J.normalize_pixel_coords(xy, (64, 80))),
        n(T.normalize_pixel_coords(t(xy), (64, 80))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(J.scale_intrinsics(K, 0.25, 0.5)),
                               n(T.scale_intrinsics(t(K), 0.25, 0.5)))


def test_sampling_matches_jax():
    from tdvnet.ops import sampling as J
    from tdvnet_torch.ops import sampling as T

    rng = np.random.default_rng(1)
    feat = rng.normal(size=(6, 7, 5)).astype(np.float32)
    # in, on the border, partly and wholly outside, and far away
    xy = np.concatenate([rng.uniform(-2, 8, (200, 2)),
                         [[0, 0], [6, 5], [-1, 2], [-0.5, -0.5], [6.5, 5.5],
                          [1e9, 3], [-1e9, -1e9], [3, 7.0]]]).astype(np.float32)
    # float32 bilinear weights: a few ulps of values of unit size
    np.testing.assert_allclose(np.asarray(J.bilinear_sample(feat, xy)),
                               n(T.bilinear_sample(t(feat), t(xy))),
                               rtol=1e-5, atol=1e-6)
    vol = rng.normal(size=(5, 6, 4, 3)).astype(np.float32)
    q = np.concatenate([rng.uniform(-2, 7, (300, 3)),
                        [[0, 0, 0], [4, 5, 3], [-1, -1, -1], [4.5, 5.5, 3.5],
                         [1e9, 0, 0], [-1e9, 2, 2]]]).astype(np.float32)
    np.testing.assert_allclose(np.asarray(J.trilinear_sample(vol, q)),
                               n(T.trilinear_sample(t(vol), t(q))),
                               rtol=1e-5, atol=1e-6)
    x = rng.normal(size=(2, 3, 13, 17)).astype(np.float32)
    for hw in ((5, 6), (26, 34), (13, 17), (7, 40)):
        np.testing.assert_array_equal(np.asarray(J.resize_nearest(x, hw)),
                                      n(T.resize_nearest(t(x), hw)))
        xc = np.moveaxis(x, 1, -1)
        np.testing.assert_array_equal(
            np.asarray(J.resize_nearest_nhwc(xc, hw)),
            n(T.resize_nearest_nhwc(t(xc), hw)))


def test_metrics2d_matches_jax():
    from tdvnet.eval import metrics2d as J
    from tdvnet_torch.eval import metrics2d as T

    rng = np.random.default_rng(2)
    gt = rng.uniform(0.2, 5, (3, 12, 16)).astype(np.float32)
    gt[0, :2] = 0.0
    pred = (gt + rng.normal(0, 0.1, gt.shape)).astype(np.float32)
    pred[1, 0, 0] = 0.0
    w = np.array([1, 1, 0], np.float32)
    pv = rng.uniform(size=gt.shape) > 0.2
    a = J.calc_2d_depth_metrics(pred, gt, w, pv)
    b = T.calc_2d_depth_metrics(t(pred), t(gt), t(w), torch.from_numpy(pv))
    assert a.keys() == b.keys()
    for k in a:
        # per-image fp32 sums of a few hundred terms
        np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=1e-5,
                                   err_msg=k)
