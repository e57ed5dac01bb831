"""The port's CUDA kernels against their plain twins, on the card, at the
shapes the full-width main path gives them (the cases of `chip_smoke.py`).

These tests need an NVIDIA card and `nvcc`; without a card they skip. The
card's machine has no JAX, so run them there without the repo's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

KERNELS = ("source_variance", "trilinear_sample", "propagation_blend",
           "softargmax_depth", "voxelize", "segment_max", "masked_group_norm",
           "trilinear_sample_i8", "patch_fan_variance", "tsdf_integrate",
           "consistency_fuse")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_matches_twin_at_main_path_shapes(kernel):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import chip_smoke

    cases = [c for c in chip_smoke.kernel_cases(torch.device("cuda"))
             if c.kernel == kernel]
    assert cases
    for case in cases:
        err, ok = chip_smoke.check_case(case)
        assert ok, f"{kernel} {case.label}: max |d| {err:.3e}"


@pytest.mark.cuda
def test_wrapper_counts_its_launches():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from tdvnet_torch.kernels import (launch_counts, reset_launch_counts,
                                      softargmax_depth)

    reset_launch_counts()
    cost = torch.randn(2, 8, 4, 4, device="cuda")
    dvals = torch.linspace(0.5, 1.0, 8, device="cuda")
    softargmax_depth(cost, dvals)
    torch.cuda.synchronize()
    assert launch_counts()["softargmax_depth"] == 1


@pytest.mark.cuda
def test_kernels_match_twins_at_hostile_coordinates():
    """Points behind a camera, near its plane (huge projected coordinates),
    at a depth whose projection overflows fp32, and far outside the grid or
    at infinity: bounds are tested in float before any float-to-int
    conversion, so the kernels agree with their twins, NaN for NaN."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from tdvnet_torch.kernels import source_variance, trilinear_sample
    from tdvnet_torch.kernels.trilinear import trilinear_sample_ref
    from tdvnet_torch.kernels.variance import source_variance_ref

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(3)
    feats = torch.randn(3, 16, 20, 8, generator=g).to(dev)
    K = torch.tensor([[60.0, 0, 40], [0, 60, 32], [0, 0, 1]])
    Rt = torch.cat([torch.eye(3), torch.zeros(3, 1)], 1)
    P_all = torch.stack([K @ (Rt + torch.tensor([[0, 0, 0, 0.1 * i],
                                                [0, 0, 0, 0], [0, 0, 0, 0]]))
                         for i in range(3)]).to(dev)
    z = torch.tensor([-2.0, -1e-9, 0.0, 1e-9, 1e-3, 0.5, 2.0, 1e6, 3e38])
    xy = torch.randn(2, 9, 2, generator=g) * 2
    pts = torch.cat([xy, z.expand(2, 9)[..., None]], -1).contiguous().to(dev)
    sidx = torch.tensor([[0, 1, 2], [2, 1, 0]], device=dev)
    smask = torch.tensor([[True, True, False], [True, True, True]],
                         device=dev)
    args = (pts, feats, sidx, smask, P_all.contiguous(), (64, 80))
    got, want = source_variance(*args), source_variance_ref(*args)
    assert torch.isnan(want[:, -1]).all()       # z = 3e38 overflows
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5, equal_nan=True)

    grid = torch.randn(2, 6, 5, 4, 8, generator=g).to(dev)
    inf = float("inf")
    q = torch.tensor([[-1e30, 0, 0], [3e38, 1, 1], [-0.99, 0.5, 0.5],
                      [5.99, 4.5, 3.5], [-2.0, 2, 2], [2.5, 2.5, 2.5],
                      [inf, 1, 1]])
    q = q.expand(2, 7, 3).contiguous().to(dev)
    c0 = torch.zeros(2, 3, device=dev)
    out = torch.zeros(2, 7, 8, device=dev)
    trilinear_sample(grid, q, c0, 1.0, out, 0)
    assert torch.allclose(out, trilinear_sample_ref(grid, q, c0, 1.0),
                          rtol=1e-5, atol=1e-6, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("max_anchors", [4096, 60, 1])
def test_voxelize_kernel_equals_twin_with_overflow_and_hostile_points(
        max_anchors):
    """Every field equal, with the anchor capacity overflowing, points out
    of the grid, invalid points, NaN and infinite coordinates, two scenes
    (one of them empty in the last case), and origins found by the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from tdvnet_torch.kernels import segmax, voxelize as vox

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(max_anchors)
    P = 5000
    pts = torch.rand(P, 3, generator=g) * 1.9 - 0.3
    pts[0, 0] = float("nan")
    pts[1, 1] = float("inf")
    pts[2, 2] = -float("inf")
    pts[3, 0] = 1e30
    scene = (torch.arange(P) * 2 // P)
    valid = torch.rand(P, generator=g) > 0.1
    if max_anchors == 1:
        valid[scene == 1] = False
    pts, scene, valid = pts.to(dev), scene.to(dev), valid.to(dev)
    origins = torch.tensor([[-0.1, 0.0, 0.05], [0.2, -0.2, 0.0]], device=dev)
    for org in (None, origins):
        args = (pts, scene, valid, 0.08, (16, 16, 16), max_anchors, 2, org)
        a, b = vox.voxelize(*args), vox.voxelize_ref(*args)
        assert a.order is None and a.p2a_sorted is None
        for f in a._fields:
            if getattr(a, f) is not None:
                assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert not a.point_valid[:4].any()
        if org is not None:
            assert (int(a.n_overflow) > 0) == (max_anchors < 1000)
        feats = torch.randn(max_anchors, 8, generator=g).to(dev)
        for x, y in zip(vox.scatter_anchors_to_dense(feats, a, (16, 16, 16), 2),
                        vox.scatter_anchors_to_dense_ref(feats, b,
                                                         (16, 16, 16), 2)):
            assert torch.equal(x, y)
        y = torch.randn(P, 8, generator=g).to(dev)
        y[7] = -6e29                     # at the empty threshold: reads as 0
        n_seg = max_anchors + 1
        pa = segmax.segment_max(y, a.point2anchor, a.point_valid, n_seg)
        assert torch.equal(pa, segmax.segment_max_ref(
            y, a.point2anchor, a.point_valid, n_seg))
        for relu in (False, True):
            assert torch.equal(
                segmax.gather_concat(y, pa, a.point2anchor, relu),
                segmax.gather_concat_ref(y, pa, a.point2anchor, relu))


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(16, 12, 8), (5, 3, 3)])
def test_masked_group_norm_kernel_matches_twin_on_empty_and_full_masks(dims):
    """Within 1e-4 of the twin's largest magnitude (the sums run in another
    order), in the three tails, with B = 2 where one element's mask is empty
    and with a mask of ones; V a multiple of 4 and not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from tdvnet_torch.kernels.groupnorm import (masked_group_norm,
                                                masked_group_norm_ref)

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(5)
    B, C, G = 2, 24, 4
    x = (torch.randn(B, C, *dims, generator=g) * 2 + 1).to(dev)
    skip = torch.randn(B, C, *dims, generator=g).to(dev)
    w = torch.randn(C, generator=g).to(dev)
    b = torch.randn(C, generator=g).to(dev)
    sparse = (torch.rand(B, 1, *dims, generator=g) > 0.6).float()
    sparse[1] = 0
    for mask in (sparse.to(dev), torch.ones(B, 1, *dims, device=dev)):
        for kw in ({}, {"relu": True}, {"skip": skip * mask}):
            got = masked_group_norm(x * mask, mask, G, w, b, **kw)
            want = masked_group_norm_ref(x * mask, mask, G, w, b, **kw)
            tol = 1e-4 * max(1.0, float(want.abs().max()))
            assert float((got - want).abs().max()) <= tol, (dims, list(kw))
            assert torch.equal(got == 0, want == 0) or mask.all()
            again = masked_group_norm(x * mask, mask, G, w, b, **kw)
            assert torch.equal(got, again)      # fixed order: it repeats


@pytest.mark.cuda
def test_scene_model_counts_its_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import chip_smoke
    from tdvnet_torch.config import tiny_test_config
    from tdvnet_torch.kernels import launch_counts, reset_launch_counts
    from tdvnet_torch.models.threedvnet import ThreeDVNet

    cfg = tiny_test_config()
    torch.manual_seed(0)
    model = ThreeDVNet(cfg.model).to("cuda").eval()
    from tdvnet_torch.data import batch as B, synthetic

    bc = cfg.batch
    batch = B.collate_scenes(
        [synthetic.make_batch_scene(bc.n_views, bc.img_size,
                                    bc.depth_img_size, seed=0)],
        bc.n_views, bc.n_ref, bc.n_src_on_either_side)
    offsets = ((0.05, 0.025), (0.025,))
    reset_launch_counts()
    depth = model.infer_depth(batch, offsets)
    torch.cuda.synchronize()
    assert torch.isfinite(depth).all()
    assert launch_counts() == chip_smoke.expected_launches(
        offsets, 1, cfg.model.unet_res)


@pytest.mark.cuda
def test_fast_path_kernels_match_twins_at_hostile_coordinates():
    """The int8 sampling across its low pad, outside the grid and at
    infinity (within one bf16 ulp, NaN for NaN), and the patch-fan variance
    with fans behind a camera, on its plane, overflowing fp32, NaN, beyond
    +-1 texel and with masked sources (within 1e-5, NaN for NaN)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from tdvnet_torch.kernels import patch_fan_variance, trilinear_sample_i8
    from tdvnet_torch.kernels.patchfan import patch_fan_variance_ref
    from tdvnet_torch.kernels.trilinear import trilinear_sample_i8_ref

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(4)
    grid = torch.randint(-127, 128, (2, 6, 5, 4, 8), generator=g,
                         dtype=torch.int8).to(dev)
    scale = torch.rand(2, 8, generator=g).to(dev)
    inf = float("inf")
    q = torch.tensor([[-1e30, 0, 0], [3e38, 1, 1], [-0.99, 0.5, 0.5],
                      [5.99, 4.5, 3.5], [-2.0, 2, 2], [2.5, 2.5, 2.5],
                      [inf, 1, 1], [-4.0, -3.5, -3.2], [2.9, 1.9, 0.9]])
    q = q.expand(2, 9, 3).contiguous().to(dev)
    c0 = torch.zeros(2, 3, device=dev)
    out = torch.zeros(2, 9, 8, dtype=torch.bfloat16, device=dev)
    trilinear_sample_i8(grid, scale, q, c0, 1.0, out, 0, cell_offset=3.0)
    want = trilinear_sample_i8_ref(grid, scale, q, c0, 1.0, 3.0)
    assert torch.allclose(out.float(), want.float(), rtol=2 ** -8, atol=0,
                          equal_nan=True)
    assert torch.isnan(out[:, 6]).all() and not torch.isnan(out[:, :6]).any()

    feats = torch.randn(3, 16, 20, 8, generator=g).to(dev)
    K = torch.tensor([[60.0, 0, 40], [0, 60, 32], [0, 0, 1]])
    Rt = torch.cat([torch.eye(3), torch.zeros(3, 1)], 1)
    P_all = torch.stack([K @ (Rt + torch.tensor([[0, 0, 0, 0.1 * i],
                                                [0, 0, 0, 0], [0, 0, 0, 0]]))
                         for i in range(3)]).to(dev).contiguous()
    z = torch.tensor([-2.0, -1e-9, 0.0, 1e-9, 1e-3, 0.5, 2.0, 1e6, 3e38,
                      float("nan")])
    xy = torch.randn(2, 1, 10, 2, generator=g) * 2
    base = torch.cat([xy, z.expand(2, 1, 10)[..., None]], -1)
    step = torch.tensor([0.0, 0.0, 0.02])
    fan = base + torch.arange(-3, 4.0)[None, :, None, None] * step
    fan[1, :, :5] += torch.tensor([0.3, 0.0, 0.0]) * torch.arange(
        -3, 4.0)[:, None, None]                       # beyond +-1 texel
    fan = fan.contiguous().to(dev)
    sidx = torch.tensor([[0, 1, 2], [2, 1, 0]], device=dev)
    smask = torch.tensor([[True, True, False], [True, True, True]],
                         device=dev)
    args = (fan, feats, sidx, smask, P_all, (64, 80))
    got, want = patch_fan_variance(*args), patch_fan_variance_ref(*args)
    assert torch.isnan(want[:, :, -2:]).all()         # 3e38 and NaN
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5, equal_nan=True)


@pytest.mark.cuda
def test_fast_scene_counts_its_kernels():
    """A tiny fast-path scene on the card launches what
    `chip_smoke.expected_launches` counts: one int8 sampling and one
    patch-fan variance per chunk pass, no fp32 sampling, no pointflow
    `source_variance`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import dataclasses

    import chip_smoke
    from tdvnet_torch.config import tiny_test_config
    from tdvnet_torch.data import synthetic
    from tdvnet_torch.eval.fused_scene import FusedSceneInference
    from tdvnet_torch.kernels import launch_counts, reset_launch_counts
    from tdvnet_torch.models.threedvnet import ThreeDVNet

    cfg = tiny_test_config()
    cfg = dataclasses.replace(cfg, eval=dataclasses.replace(
        cfg.eval, fused_chunk=4, n_src_on_either_side=1,
        eval_grid_size=(16, 16, 16), eval_max_anchors=2048, grid_bucket=8,
        fast_path=True, fast_rank=48))
    torch.manual_seed(0)
    model = ThreeDVNet(cfg.model).to("cuda").eval()
    inf = FusedSceneInference(model, cfg, fetch_mm=False)
    views = synthetic.make_scene(n_views=11, img_size=(64, 80), seed=2)
    reset_launch_counts()
    depth = inf.predict_scene(views)
    torch.cuda.synchronize()
    assert np.isfinite(depth).all() and depth.shape == (9, 64, 80)
    assert inf.last_projected and inf.last_n_tables == 1
    assert launch_counts() == chip_smoke.expected_launches(
        inf.offsets_list, 3, cfg.model.unet_res, True, 1)


def _k9_scene(n_views, hw, seed=5):
    from tdvnet_torch.data import synthetic

    sc = synthetic.make_scene(n_views, hw, seed=seed, normalize=False)
    rng = np.random.default_rng(seed)
    d = sc["depth"] * (1 + rng.normal(0, 0.003, sc["depth"].shape))
    d[rng.random(d.shape) < 0.05] = 0
    sc["noisy"] = d.astype(np.float32)
    sc["P"] = np.einsum("nij,njk->nik", sc["K"], np.concatenate(
        [sc["rotmats"], sc["tvecs"][..., None]], 2)).astype(np.float32)
    return sc


@pytest.mark.cuda
@pytest.mark.parametrize("n_views,hw,dims,split", [
    (8, (48, 64), (30, 29, 20), 8),
    # ragged: more frames than one shared-memory tile (64), odd sizes, and
    # the accumulators carried from a first batch into a second
    (70, (37, 53), (23, 17, 11), 41)])
def test_tsdf_integrate_kernel_matches_twin(n_views, hw, dims, split):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import chip_smoke
    from tdvnet_torch.kernels import tsdf_integrate
    from tdvnet_torch.kernels.tsdf import tsdf_integrate_ref

    sc = _k9_scene(n_views, hw)
    dev = torch.device("cuda")
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    origin = torch.tensor([-2.3, -2.2, -0.25])
    vs = 4.6 / dims[0]
    got = want = None
    for sl in (slice(0, split), slice(split, n_views)):
        if sl.start == sl.stop:
            continue
        args = (up(sc["noisy"][sl]), up(sc["images"][sl] * 255),
                up(sc["P"][sl]), origin, dims, vs, 3.0)
        got = tsdf_integrate(*args, init=got)
        want = tsdf_integrate_ref(*args, init=want)
    torch.cuda.synchronize()
    err, ok = chip_smoke.tsdf_check(got, want)
    assert ok, err
    assert float(want[1].max()) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("n_views,hw,refs", [
    (8, (48, 64), (0, 5)),
    # ragged: more views than one shared-memory tile (64), odd sizes, the
    # last refs of the scene
    (70, (37, 53), (67, 70))])
def test_consistency_fuse_kernel_matches_twin(n_views, hw, refs):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import chip_smoke
    from tdvnet_torch.kernels import consistency_fuse
    from tdvnet_torch.kernels.fusion import camera_table, consistency_fuse_ref

    sc = _k9_scene(n_views, hw, seed=6)
    dev = torch.device("cuda")
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    d = up(sc["noisy"])
    cams = camera_table(up(sc["K"]), up(sc["rotmats"]), up(sc["tvecs"]))
    c0, c1 = refs
    args = (d[c0:c1], d, cams, torch.arange(c0, c1, device=dev), 0.01, 2)
    got, want = consistency_fuse(*args), consistency_fuse_ref(*args)
    torch.cuda.synchronize()
    err, ok = chip_smoke.fuse_check(got, want)
    assert ok, err
    assert 0 < int(want[1].sum()) < want[1].numel()


@pytest.mark.cuda
def test_k9_wrappers_count_their_launches():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from tdvnet_torch.kernels import launch_counts, reset_launch_counts
    from tdvnet_torch.ops import fusion, tsdf

    sc = _k9_scene(8, (48, 64))
    reset_launch_counts()
    tsdf.fuse_scene(sc["noisy"], sc["images"] * 255, sc["P"],
                    voxel_size=0.1, frame_batch=3, device="cuda")
    fusion.fuse_point_cloud(sc["noisy"], (sc["images"] * 255).astype(
        np.uint8), sc["rotmats"], sc["tvecs"], sc["K"], 0.01, 2,
        ref_chunk=3, device="cuda")
    counts = launch_counts()
    assert counts["tsdf_integrate"] == 3 and counts["consistency_fuse"] == 3
    assert sum(counts.values()) == 6


@pytest.mark.cuda
def test_imageio_and_synthetic_dataset_need_no_cv2(tmp_path):
    """The port's PNG codec and dataset writer on the card's machine: a
    scene written with the GT mesh fused on the card reads back through
    `Dataset` exactly, and its mesh is within 0.5% of the CPU twin's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import sys

    from tdvnet_torch.data import frameselector, imageio, synthetic
    from tdvnet_torch.data.dataset import Dataset
    from tdvnet_torch.data.synthetic_dataset import make_scene_dir
    from tdvnet_torch.ops import ply

    d_gpu = make_scene_dir(str(tmp_path / "gpu"), "s", 10, (60, 80), 3,
                           device="cuda")
    d_cpu = make_scene_dir(str(tmp_path / "cpu"), "s", 10, (60, 80), 3,
                           device="cpu")
    sc = synthetic.make_scene(10, (60, 80), seed=3, normalize=False)
    for i in range(10):
        bgr = imageio.imread(f"{d_gpu}/color/{i:05d}.png")
        assert np.array_equal(bgr, (sc["images"][i][..., ::-1] * 255)
                              .astype(np.uint8))
        dep = imageio.imread_depth(f"{d_gpu}/depth/{i:05d}.png")
        assert np.array_equal(dep, (sc["depth"][i] * 1000).astype(np.uint16))
    views = Dataset([d_gpu], frameselector.NextPoseDistSelector(0.05, 20),
                    img_size=(64, 80)).load_views(0, seed_idx=0)
    assert views["images_u8"].shape[1:] == (64, 80, 3)
    gv, gf, _ = ply.read_ply(f"{d_gpu}/gt_mesh.ply")
    cv, cf, _ = ply.read_ply(f"{d_cpu}/gt_mesh.ply")
    assert len(gf) > 0 and abs(len(gv) - len(cv)) <= 0.005 * len(cv)
    assert "cv2" not in sys.modules
