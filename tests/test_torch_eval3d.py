"""The port's 3D evaluation against the JAX package on the same numpy
inputs: the K9a and K9b twins, TSDF fusion, consistency fusion, marching,
PLY, point clouds, the rasterizer, the 3D metrics, and `harness.main` of
both packages over one 2-scene synthetic dataset (one JAX run per module,
shared by the tests that read it).

Limits (the port's, stated once): TSDF weights equal on at least 99.99% of
voxels, tsdf and colour within 1e-5 where the weights agree; keep flags
equal on at least 99.9% of pixels, points within 1e-5 m where both keep;
2D metrics within 1e-5 relative; `acc`/`comp` within 1e-4 m,
`prec`/`recal`/`fscore` within 2e-3, point counts within 0.1%."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from _torch_helpers import torch_one_thread  # noqa: F401 (autouse)

HW = (60, 80)
EVAL = {"depth_img_size": HW, "pdist": 0.05, "n_src_on_either_side": 1,
        "z_thresh": 0.02, "n_consistent_thresh": 2, "run_tsdf_fusion": True}
PASSTHROUGH_FILES = ("metrics_2d.json", "metrics_3d_0.020_2v_masked.json",
                     "metrics_tsdf_masked.json")


def _scene(n_views=8, hw=(48, 64), seed=3):
    from tdvnet_torch.data import synthetic

    sc = synthetic.make_scene(n_views, hw, seed=seed, normalize=False)
    P = np.einsum("nij,njk->nik", sc["K"], np.concatenate(
        [sc["rotmats"], sc["tvecs"][..., None]], 2)).astype(np.float32)
    return sc, P, (sc["images"] * 255).astype(np.float32)


def _noisy(depth, seed=0):
    rng = np.random.default_rng(seed)
    d = depth * (1 + rng.normal(0, 0.003, depth.shape))
    d[rng.random(depth.shape) < 0.05] = 0
    return d.astype(np.float32)


def _tsdf_close(want, got):
    (jt, jw, jc), (tt, tw, tc) = [[np.asarray(a) for a in x]
                                  for x in (want, got)]
    agree = jw == tw
    assert agree.mean() >= 0.9999
    assert np.abs(jt - tt)[agree].max() <= 1e-5
    assert np.abs(jc - tc)[agree].max() <= 1e-5 * max(1.0, np.abs(jc).max())


# ------------------------------------------------------------- K9a and TSDF
def test_tsdf_integrate_twin_matches_jax_with_carried_init():
    """Two frame batches, the second carrying the first's accumulators, as
    `fuse_scene` runs them."""
    import jax.numpy as jnp

    from tdvnet.ops import tsdf as J
    from tdvnet_torch.kernels import tsdf_integrate

    sc, P, cols = _scene()
    origin = np.array([-2.3, -2.2, -0.25], np.float32)
    dims, vs = (30, 29, 20), 0.16
    acc_j = acc_t = None
    before = tsdf_integrate.launches
    for sl in (slice(0, 5), slice(5, 8)):
        acc_j = J.integrate_frames(
            jnp.asarray(sc["depth"][sl]), jnp.asarray(cols[sl]),
            jnp.asarray(P[sl]), jnp.asarray(origin), dims, vs, 3.0,
            init=acc_j)
        acc_t = tsdf_integrate(
            torch.from_numpy(sc["depth"][sl]), torch.from_numpy(cols[sl]),
            torch.from_numpy(P[sl]), torch.from_numpy(origin), dims, vs, 3.0,
            init=acc_t)
    assert tsdf_integrate.launches == before        # CPU tensors: the twin
    assert float(np.asarray(acc_j[1]).max()) > 1
    _tsdf_close(acc_j, acc_t)


def test_fuse_scene_matches_jax():
    from tdvnet.ops import tsdf as J
    from tdvnet_torch.ops import tsdf as T

    sc, P, cols = _scene()
    kw = dict(voxel_size=0.1, margin=0.3, frame_batch=3)
    jv = J.fuse_scene(sc["depth"], cols, P, **kw)
    tv = T.fuse_scene(sc["depth"], cols, P, device="cpu",
                      **kw)
    assert tv.dims == tuple(jv.dims)
    assert np.array_equal(tv.origin, np.asarray(jv.origin))
    _tsdf_close((jv.tsdf, jv.weight, jv.color),
                (tv.tsdf, tv.weight, tv.color))


# ------------------------------------------------------ K9b and point fusion
@pytest.mark.parametrize("chunk", [(0, 5), (5, 8)])
def test_consistency_fuse_twin_matches_jax(chunk):
    import jax.numpy as jnp

    from tdvnet.ops import fusion as J
    from tdvnet_torch.kernels import consistency_fuse
    from tdvnet_torch.kernels.fusion import camera_table

    sc, _, _ = _scene()
    d = _noisy(sc["depth"])
    c0, c1 = chunk
    a = lambda x: jnp.asarray(x)
    jp, jk = J._fuse_chunk(
        a(d[c0:c1]), a(sc["rotmats"][c0:c1]), a(sc["tvecs"][c0:c1]),
        a(sc["K"][c0:c1]), a(d), a(sc["rotmats"]), a(sc["tvecs"]),
        a(sc["K"]), jnp.arange(c0, c1), z_thresh=0.01, n_consistent=2)
    cams = camera_table(*(torch.from_numpy(sc[k])
                          for k in ("K", "rotmats", "tvecs")))
    tp, tk = consistency_fuse(torch.from_numpy(d[c0:c1]), torch.from_numpy(d),
                              cams, torch.arange(c0, c1), 0.01, 2)
    jp, jk, tp, tk = (np.asarray(x) for x in (jp, jk, tp, tk))
    assert tp.shape == jp.shape and tk.shape == jk.shape
    assert (jk == tk).mean() >= 0.999 and 100 < jk.sum() < jk.size
    both = jk & tk
    assert np.abs(jp - tp)[both].max() <= 1e-5


def test_camera_table_matches_jax_projection_and_inverse():
    import jax.numpy as jnp

    from tdvnet.ops import camera as J
    from tdvnet_torch.kernels.fusion import camera_table

    sc, _, _ = _scene()
    cams = camera_table(*(torch.from_numpy(sc[k])
                          for k in ("K", "rotmats", "tvecs"))).numpy()
    P = np.asarray(J.projection_matrix(*(jnp.asarray(sc[k]) for k in
                                         ("K", "rotmats", "tvecs"))))
    assert np.array_equal(cams[:, :12], P.reshape(-1, 12))
    assert np.array_equal(cams[:, 12:21], np.asarray(
        jnp.linalg.inv(jnp.asarray(sc["K"]))).reshape(-1, 9))


def test_fuse_point_cloud_matches_jax():
    from tdvnet.ops import fusion as J
    from tdvnet_torch.ops import fusion as T

    sc, _, _ = _scene()
    d = _noisy(sc["depth"], 1)
    imgs = (sc["images"] * 255).astype(np.uint8)
    args = (d, imgs, sc["rotmats"], sc["tvecs"], sc["K"], 0.01, 2, 3)
    jp, jc = J.fuse_point_cloud(*args)
    tp, tc = T.fuse_point_cloud(*args, device="cpu")
    assert abs(len(tp) - len(jp)) <= 1e-3 * len(jp)
    if len(tp) == len(jp):
        assert np.abs(tp - jp).max() <= 1e-5 and np.array_equal(tc, jc)


# ------------------------------------------------ host ops, exactly as JAX
def test_marching_ply_pointcloud_metrics_match_jax(tmp_path):
    from tdvnet.eval import metrics3d as JM
    from tdvnet.ops import marching as JMa, ply as JP, pointcloud as JC
    from tdvnet_torch.eval import metrics3d as TM
    from tdvnet_torch.ops import marching as TMa, ply as TP, pointcloud as TC

    rng = np.random.default_rng(4)
    g = np.stack(np.meshgrid(*[np.linspace(-1, 1, 14)] * 3, indexing="ij"),
                 -1)
    vol = (np.linalg.norm(g, axis=-1) - 0.6).astype(np.float32)
    mask = rng.random(vol.shape) > 0.02
    jv, jf = JMa.marching_tetrahedra(vol, 0.0, mask)
    tv, tf = TMa.marching_tetrahedra(vol, 0.0, mask)
    assert np.array_equal(jv, tv) and np.array_equal(jf, tf) and len(tf)
    cols = rng.integers(0, 256, (len(tv), 3)).astype(np.uint8)
    for mod, name in ((JP, "j"), (TP, "t")):
        mod.write_ply(str(tmp_path / f"{name}.ply"), tv, tf)
        mod.write_ply(str(tmp_path / f"{name}c.ply"), tv, colors=cols)
    for suffix in ("", "c"):
        with open(tmp_path / f"j{suffix}.ply", "rb") as a, \
                open(tmp_path / f"t{suffix}.ply", "rb") as b:
            assert a.read() == b.read()
        for x, y in zip(JP.read_ply(str(tmp_path / f"j{suffix}.ply")),
                        TP.read_ply(str(tmp_path / f"j{suffix}.ply"))):
            assert (x is None and y is None) or np.array_equal(x, y)
    pts = rng.normal(0, 1, (500, 3)).astype(np.float32)
    jd, jdc = JC.voxel_downsample(pts, 0.3, cols[:500])
    td, tdc = TC.voxel_downsample(pts, 0.3, cols[:500])
    assert np.array_equal(jd, td) and np.array_equal(jdc, tdc)
    assert np.array_equal(JC.nn_distances(pts, tv), TC.nn_distances(pts, tv))
    assert JM.eval_point_clouds(pts, tv, 0.2) == TM.eval_point_clouds(
        pts, tv, 0.2)


def test_rasterizer_matches_jax_and_its_numpy_twin():
    from tdvnet.ops import raster as J
    from tdvnet_torch.ops import raster as T

    verts = np.array([[-1, -1, 2], [1, -1, 2.5], [0, 1, 3], [1, 1, 2.2]],
                     np.float32)
    faces = np.array([[0, 1, 2], [1, 3, 2]], np.int32)
    K = np.array([[40, 0, 32], [0, 40, 24], [0, 0, 1]], np.float32)
    pose = np.eye(4, dtype=np.float32)
    want = J.render_depth(verts, faces, K, pose, (48, 64))
    got = T.render_depth(verts, faces, K, pose, (48, 64))
    assert np.array_equal(got, want) and (got > 0).sum() > 200
    twin = T.rasterize_depth_ref(verts, faces, K, 48, 64)
    both = (twin > 0) & (got > 0)
    assert (both == (got > 0)).mean() > 0.99
    assert np.abs(twin - got)[both].max() < 1e-4
    assert T.library().rasterize_depth is not None
    assert os.path.dirname(T.BUILD_ROOT).endswith("build")


# ------------------------------------------------------------------ harness
@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Two 10-view 60x80 scenes written by the JAX package's tool."""
    from tools.make_synthetic_dataset import make_scene_dir

    root = str(tmp_path_factory.mktemp("eval3d"))
    return [make_scene_dir(root, f"synth_{s:04d}", n_views=10, hw=HW, seed=s)
            for s in range(2)]


def _gt_pred_fn(views, scene_dir, dset):
    k = dset.k
    return views["depth"][k:-k]


def _mesh_pred_fn(views, scene_dir, dset, ply_mod):
    with open(os.path.join(scene_dir, "info.json")) as f:
        verts, faces, _ = ply_mod.read_ply(json.load(f)["gt_mesh"])
    return verts, faces


@pytest.fixture(scope="module")
def both_runs(dataset, tmp_path_factory):
    """`harness.main` of both packages, GT passthrough (depth) and the GT
    mesh (the depth=False mesh branch)."""
    from tdvnet.config import load_config as jload
    from tdvnet.eval import harness as JH
    from tdvnet.ops import ply as JP
    from tdvnet_torch.config import load_config as tload
    from tdvnet_torch.eval import harness as TH
    from tdvnet_torch.ops import ply as TP

    out = {}
    for tag, load, H, P in (("jax", jload, JH, JP), ("torch", tload, TH, TP)):
        save = str(tmp_path_factory.mktemp(f"res_{tag}"))
        cfg = load({"batch": {"img_size": HW},
                    "eval": dict(EVAL, save_dir=save)})
        kw = {"device": "cpu"} if tag == "torch" else {}
        avg = H.main("gt", _gt_pred_fn, cfg, scenes=dataset, **kw)
        mesh = H.main("mesh", lambda v, s, d, P=P: _mesh_pred_fn(v, s, d, P),
                      cfg, depth=False, scenes=dataset, **kw)
        out[tag] = (save, avg, mesh, cfg)
    return out


def _close(name, key, want, got):
    if key in ("acc", "comp"):
        assert abs(got - want) <= 1e-4, (name, key)
    elif key in ("prec", "recal", "fscore"):
        assert abs(got - want) <= 2e-3, (name, key)
    elif key.startswith("n_"):
        assert abs(got - want) <= 1e-3 * max(want, 1), (name, key)
    else:
        assert abs(got - want) <= 1e-5 * max(abs(want), 1e-12), (name, key)


@pytest.mark.parametrize("name", PASSTHROUGH_FILES)
def test_harness_gt_passthrough_metrics_match_jax(both_runs, name):
    want, got = both_runs["jax"][1][name], both_runs["torch"][1][name]
    assert set(got) == set(want)
    for k in want:
        _close(name, k, want[k], got[k])
    if name != "metrics_2d.json":
        assert got["prec"] > 0.95


def test_harness_writes_reference_files_and_equal_preds(both_runs, dataset):
    jsave, tsave = both_runs["jax"][0], both_runs["torch"][0]
    for scene in dataset:
        sd = lambda save: os.path.join(save, "gt", "scenes",
                                       os.path.basename(scene))
        names = sorted(os.listdir(sd(jsave)))
        assert sorted(os.listdir(sd(tsave))) == names
        assert "fused_0.020_2v_masked.ply" in names
        assert "tsdf_mesh_masked.ply" in names
        with np.load(os.path.join(sd(jsave), "preds.npz")) as a, \
                np.load(os.path.join(sd(tsave), "preds.npz")) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert np.array_equal(a[k], b[k]), k
    for name in PASSTHROUGH_FILES:
        assert os.path.exists(os.path.join(tsave, "gt", name))


def test_harness_mesh_branch_matches_jax(both_runs):
    want, got = both_runs["jax"][2], both_runs["torch"][2]
    assert set(got) == set(want) == {"metrics_2d.json",
                                     "metrics_3d_masked.json"}
    for name in want:
        for k in want[name]:
            _close(name, k, want[name][k], got[name][k])


def test_harness_rerun_reuses_every_cached_file(both_runs, dataset):
    from tdvnet_torch.eval import harness as TH

    save, avg, _, cfg = both_runs["torch"]
    root = os.path.join(save, "gt", "scenes")
    stamp = lambda: {os.path.join(d, f): os.stat(os.path.join(root, d, f))
                     .st_mtime_ns for d in os.listdir(root)
                     for f in os.listdir(os.path.join(root, d))}
    before = stamp()

    def never(views, scene_dir, dset):
        raise AssertionError("cached preds.npz not reused")

    assert TH.main("gt", never, cfg, scenes=dataset, device="cpu") == avg
    assert stamp() == before


def test_harness_runs_the_tiny_model(dataset, tmp_path):
    """The port's harness end to end with the model's own `pred_fn`
    (random weights, tiny config, fast path on): a finite depth for every
    ref, every metric file written, and host seconds for every stage."""
    from tdvnet_torch.config import tiny_test_config
    from tdvnet_torch.eval import harness as TH
    from tdvnet_torch.models.threedvnet import ThreeDVNet

    torch.manual_seed(0)
    cfg = tiny_test_config()
    cfg = dataclasses.replace(cfg, eval=dataclasses.replace(
        cfg.eval, save_dir=str(tmp_path), fused_chunk=4,
        eval_grid_size=(16, 16, 16), eval_max_anchors=2048, grid_bucket=8,
        **EVAL))
    model = ThreeDVNet(cfg.model).eval()
    timings = {}
    avg = TH.main("tiny", TH.make_3dvnet_pred_fn(model, cfg), cfg,
                  scenes=dataset[:1], device="cpu", timings=timings)
    assert set(avg) == set(PASSTHROUGH_FILES)
    assert set(timings) == {
        "eval_load", "eval_predict", "eval_2d", "eval_mask_raster",
        "eval_pc_fusion", "eval_downsample_kdtree", "eval_tsdf",
        "eval_marching", "eval_write"}
    assert all(v > 0 for v in timings.values())
    with np.load(os.path.join(tmp_path, "tiny", "scenes",
                              os.path.basename(dataset[0]),
                              "preds.npz")) as z:
        assert z["depth_preds"].shape[1:] == cfg.model.img_size
        assert np.isfinite(z["depth_preds"]).all()


def test_prob_maps_are_not_ported_yet(both_runs, dataset, tmp_path):
    from tdvnet_torch.eval import processresults as T

    scene = dataset[0]
    src = os.path.join(both_runs["torch"][0], "gt", "scenes",
                       os.path.basename(scene), "preds.npz")
    with np.load(src) as z:
        preds = dict(z)
    preds["init_prob"] = np.ones_like(preds["depth_preds"])
    np.savez(os.path.join(tmp_path, "preds.npz"), **preds)
    ecfg = both_runs["torch"][3].eval
    with pytest.raises(NotImplementedError, match="init_prob"):
        T.process_depth_3d_metrics(scene, str(tmp_path), ecfg, device="cpu")
