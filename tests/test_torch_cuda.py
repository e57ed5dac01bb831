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
           "softargmax_depth", "voxelize", "segment_plan", "segment_max",
           "masked_group_norm",
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
    got, want = source_variance(*args, (1, 9)), source_variance_ref(*args)
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
    infinity (equal to its twin, NaN for NaN), and the patch-fan variance
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
    want = trilinear_sample_i8_ref(grid.cpu(), scale.cpu(), q.cpu(),
                                   c0.cpu(), 1.0, 3.0)
    _same_values(out.cpu(), want)
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


def _hostile_depths(d):
    """NaN, inf, negative and zero depths in blocks that straddle tiles, and
    a whole map of zeros."""
    d = d.copy()
    d[0, :3] = np.nan
    d[1, 5:9, 10:20] = np.inf
    d[2, 20:, 30:] *= -1
    d[3] = 0
    d[4, ::7, ::5] = 0
    return d


def _runs(skip, members):
    """The share of a cull's (tile or brick, view or frame) pairs it runs,
    weighted by members."""
    return float((members[..., None] * ~skip).sum()) / float(
        members.sum() * skip.shape[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["hostile", "mostly_culled"])
def test_consistency_fuse_tiles_match_twin(case):
    """Tiles that straddle the map's edges (37x53), more views than one
    shared tile (70), NaN, inf, negative and zero depths in refs and
    sources; and a scene whose tiles cull most views. The kernel's points
    and flags against the twin's; depth_max handed over or reduced by the
    wrapper gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import chip_smoke
    from tdvnet_torch.kernels import consistency_fuse
    from tdvnet_torch.kernels.fusion import (camera_table,
                                             consistency_fuse_ref,
                                             fuse_skip_ref)

    n_views, hw = (70, (37, 53)) if case == "hostile" else (40, (48, 64))
    sc = _k9_scene(n_views, hw, seed=7)
    d = _hostile_depths(sc["noisy"]) if case == "hostile" else sc["noisy"]
    dev = torch.device("cuda")
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    d = up(d)
    cams = camera_table(up(sc["K"]), up(sc["rotmats"]), up(sc["tvecs"]))
    refs = (0, 8) if case == "hostile" else (10, 26)
    args = (d[refs[0]:refs[1]], d, cams,
            torch.arange(*refs, device=dev), 0.01, 2)
    dmax = d.reshape(n_views, -1).amax(1)
    got = consistency_fuse(*args)
    again = consistency_fuse(*args, depth_max=dmax)
    want = consistency_fuse_ref(*args)
    torch.cuda.synchronize()
    assert chip_smoke.same_bits(got, again)
    err, ok = chip_smoke.fuse_check(got, want)
    assert ok, err
    assert int(want[1].sum()) > 0
    skip, members, _, _ = fuse_skip_ref(*args[:5], depth_max=dmax)
    if case == "mostly_culled":
        assert _runs(skip, members) < 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["hostile", "mostly_culled"])
def test_tsdf_integrate_bricks_match_twin(case):
    """Bricks that straddle the volume's edges (dims not multiples of 2x8x16),
    more frames than one shared tile (70), the accumulators carried into a
    second batch, NaN, inf, negative and zero depths, uint8 colours; and a
    volume far larger than the room, whose bricks cull most frames. The
    kernel against the twin; uint8 and fp32 colours give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import chip_smoke
    from tdvnet_torch.kernels import tsdf_integrate
    from tdvnet_torch.kernels.tsdf import tsdf_integrate_ref, tsdf_skip_ref

    hostile = case == "hostile"
    n_views = 70 if hostile else 30
    sc = _k9_scene(n_views, (37, 53))
    d = _hostile_depths(sc["noisy"]) if hostile else sc["noisy"]
    dev = torch.device("cuda")
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    u8 = up((sc["images"] * 255).astype(np.uint8))
    if hostile:
        origin, dims, vs = torch.tensor([-2.3, -2.2, -0.25]), (23, 17, 11), 0.2
    else:
        origin, dims, vs = torch.tensor([-9.0, -9.0, -6.0]), (90, 90, 70), 0.2
    got = want = got8 = None
    for sl in ((slice(0, 41), slice(41, n_views)) if hostile
               else (slice(0, n_views),)):
        a = (up(d[sl]), u8[sl].float(), up(sc["P"][sl]), origin, dims, vs,
             3.0)
        got = tsdf_integrate(*a, init=got)
        got8 = tsdf_integrate(a[0], u8[sl], *a[2:], init=got8)
        want = tsdf_integrate_ref(*a, init=want)
    torch.cuda.synchronize()
    assert chip_smoke.same_bits(got, got8)
    err, ok = chip_smoke.tsdf_check(got, want)
    assert ok, err
    assert float(want[1].max()) > 1
    if not hostile:
        skip, brick = tsdf_skip_ref(up(d), up(sc["P"]), origin, dims, vs)
        members = torch.bincount(brick, minlength=skip.shape[0])
        assert _runs(skip, members) < 0.5


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


# ------------------------------------------------------------- training
BACKWARD_KERNELS = ("source_variance_backward", "softargmax_depth_backward",
                    "propagation_blend_backward", "scatter_dense_backward",
                    "segment_max_backward", "masked_group_norm_backward",
                    "trilinear_sample_backward")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", BACKWARD_KERNELS)
def test_backward_kernel_matches_twin_at_train_shapes(kernel):
    """Each backward kernel against its twin at the shapes the full-width
    n_iters=0 and n_iters=1 train steps give it
    (`chip_smoke.train_cases`, `chip_smoke.train_refine_cases`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import chip_smoke

    dev = torch.device("cuda")
    cases = [c for c in chip_smoke.train_cases(dev)
             + chip_smoke.train_refine_cases(dev) if c.kernel == kernel]
    assert cases
    for case in cases:
        err, ok = chip_smoke.check_case(case)
        assert ok, f"{kernel} {case.label}: max |d| {err:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(6, 7), (1, 5), (2, 1), (33, 40)])
def test_backward_kernels_match_twins_at_small_and_edge_shapes(hw):
    """The three backward kernels at small shapes, maps of one row or one
    column included (where several taps clamp onto one pixel), with the
    logits as a permuted view as PropagationNet hands them over."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from tdvnet_torch import kernels as K
    from tdvnet_torch.kernels.propagation import propagation_blend_ref
    from tdvnet_torch.kernels.softargmax import softargmax_depth_ref

    H, W = hw
    g = torch.Generator().manual_seed(H * 100 + W)
    r = lambda *s: torch.randn(*s, generator=g)
    logits = r(3, 9, H, W).cuda().permute(0, 2, 3, 1)
    depth = (1 + 3 * torch.rand(3, H, W, generator=g)).cuda()
    gout = r(3, H, W).cuda()
    out = propagation_blend_ref(logits, depth)
    got = K.propagation_blend_backward(gout, logits, depth, out)
    want = K.propagation_blend_backward(gout.cpu(), logits.cpu(),
                                        depth.cpu(), out.cpu())
    assert got[0].stride() == logits.stride()
    for a, b in zip(got, want):
        assert torch.allclose(a.cpu(), b, rtol=1e-5, atol=1e-6)
    cost = (r(3, 8, H, W) * 3).cuda()
    dv = torch.linspace(0.5, 1.0, 8).cuda()
    d = softargmax_depth_ref(cost, dv)
    got = K.softargmax_depth_backward(gout, cost, dv, d)
    want = K.softargmax_depth_backward(gout.cpu(), cost.cpu(), dv.cpu(),
                                       d.cpu())
    assert torch.allclose(got.cpu(), want, rtol=1e-5, atol=1e-6)


def _variance_args(device, R=3, P=500, N=5, Hf=16, Wf=20, C=8, seed=0):
    from tdvnet_torch.ops import camera

    g = torch.Generator().manual_seed(seed)
    K = torch.tensor([[40.0, 0, 40], [0, 40, 32], [0, 0, 1]]).expand(N, 3, 3)
    rot = torch.eye(3).expand(N, 3, 3)
    tv = torch.stack([torch.tensor([0.1 * i, 0.0, 0.0]) for i in range(N)])
    P_all = camera.projection_matrix(K, rot, tv).contiguous()
    pts = torch.randn(R, P, 3, generator=g) * 0.8 + torch.tensor([0, 0, 2.0])
    feats = torch.randn(N, Hf, Wf, C, generator=g)
    src_idx = torch.tensor([[0, 1, 2], [1, 2, 3], [2, 3, 4]])[:R]
    src_mask = torch.tensor([[True, True, True], [True, True, False],
                             [True, False, True]])[:R]
    grad = torch.randn(R, P, C, generator=g)
    return [x.to(device) for x in (pts, feats, src_idx, src_mask, P_all,
                                   grad)]


@pytest.mark.cuda
def test_source_variance_backward_kernel_matches_twin_small():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from tdvnet_torch import kernels as K
    from tdvnet_torch.kernels.variance import source_variance_ref

    pts, feats, sidx, smask, P_all, grad = _variance_args("cuda")
    img = (64, 80)
    _, mean = source_variance_ref(pts, feats, sidx, smask, P_all, img,
                                  with_mean=True)
    plane = (1, pts.shape[1])
    got = K.source_variance_backward(grad, mean, pts, feats, sidx, smask,
                                     P_all, img, plane)
    want = K.source_variance_backward(*(x.cpu() for x in (
        grad, mean, pts, feats, sidx, smask, P_all)), img, plane)
    # atomics sum in a run-dependent order
    assert torch.allclose(got.cpu(), want, rtol=1e-5, atol=1e-5)
    # the forward's mean output equals the twin's
    f = feats.clone().requires_grad_()
    K.source_variance(pts, f, sidx, smask, P_all, img, plane).backward(grad)
    assert torch.allclose(f.grad.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_wrappers_raise_or_differentiate_when_inputs_require_grad():
    """On the card a wrapper without a hand backward (the fast path's,
    3D evaluation's, voxelization, the in-place scene sampling) raises for
    an input that requires grad (its launch returns no grad_fn); the eight
    with one differentiate; under inference_mode every wrapper runs as
    before."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from tdvnet_torch import kernels as K
    from tdvnet_torch.kernels.fusion import camera_table
    from tdvnet_torch.kernels.voxelize import VoxelGrid

    dev = torch.device("cuda")
    rg = lambda x: x.clone().requires_grad_()
    pts, feats, sidx, smask, P_all, grad = _variance_args(dev)
    y = torch.randn(50, 8, device=dev)
    seg = torch.randint(0, 6, (50,), device=dev)
    valid = torch.ones(50, dtype=torch.bool, device=dev)
    pooled = torch.randn(6, 8, device=dev)
    x = torch.randn(1, 8, 4, 4, 4, device=dev)
    mask = torch.ones(1, 1, 4, 4, 4, device=dev)
    w, b = torch.ones(8, device=dev), torch.zeros(8, device=dev)
    grid = torch.randn(1, 4, 4, 4, 8, device=dev)
    q = torch.rand(1, 10, 3, device=dev)
    c0 = torch.zeros(1, 3, device=dev)
    out = torch.zeros(1, 10, 8, device=dev)
    depths = torch.rand(2, 6, 7, device=dev) + 1
    colors = torch.rand(2, 6, 7, 3, device=dev)
    cams = camera_table(torch.tensor([[5.0, 0, 3], [0, 5, 3], [0, 0, 1]])
                        .expand(2, 3, 3), torch.eye(3).expand(2, 3, 3),
                        torch.tensor([[0.0, 0, 0], [0.1, 0, 0]])).to(dev)
    raising = {
        # the in-place write into a channel slice carries no gradient
        # (training samples through `trilinear_sample_scale`)
        "trilinear_sample": lambda: K.trilinear_sample(rg(grid), q, c0, 0.5,
                                                       out, 0),
        "patch_fan_variance": lambda: K.patch_fan_variance(
            pts[:, None].expand(3, 3, 500, 3).contiguous(), rg(feats), sidx,
            smask, P_all, (64, 80)),
        "voxelize": lambda: K.voxelize_points(
            rg(pts.reshape(-1, 3)), torch.zeros(1500, dtype=torch.long,
                                                device=dev),
            torch.ones(1500, dtype=torch.bool, device=dev), 0.1, (8, 8, 8),
            64, 1),
        "tsdf_integrate": lambda: K.tsdf_integrate(
            rg(depths), colors, P_all[:2], torch.zeros(3), (4, 4, 4), 0.1),
        "consistency_fuse": lambda: K.consistency_fuse(
            rg(depths), depths, cams, torch.tensor([0, 1], device=dev),
            0.01, 1),
    }
    for name, call in raising.items():
        with pytest.raises(NotImplementedError, match=name):
            call()
    vg = K.voxelize_points(pts.reshape(-1, 3), torch.zeros(
        1500, dtype=torch.long, device=dev), torch.ones(
        1500, dtype=torch.bool, device=dev), 0.1, (8, 8, 8), 64, 1)
    assert isinstance(vg, VoxelGrid)
    scale = torch.ones(1, 8, device=dev).requires_grad_()
    with pytest.raises(NotImplementedError, match="trilinear_sample_i8"):
        K.trilinear_sample_i8(torch.zeros(1, 4, 4, 4, 8, dtype=torch.int8,
                                          device=dev), scale, q, c0, 0.5,
                              torch.zeros(1, 10, 8, dtype=torch.bfloat16,
                                          device=dev), 0)
    with pytest.raises(NotImplementedError, match="points"):
        K.source_variance(rg(pts), feats, sidx, smask, P_all, (64, 80),
                          (1, pts.shape[1]))
    from tdvnet_torch.kernels.trilinear import trilinear_sample_scale

    with pytest.raises(NotImplementedError, match="points"):
        trilinear_sample_scale(grid, rg(q), c0, 0.5)
    # the eight with a hand backward carry a grad_fn and count both launches
    K.reset_launch_counts()
    v = K.source_variance(pts, rg(feats), sidx, smask, P_all, (64, 80),
                          (1, pts.shape[1]))
    d = K.softargmax_depth(rg(torch.randn(2, 8, 4, 4, device=dev)),
                           torch.linspace(0.5, 1, 8, device=dev))
    p = K.propagation_blend(rg(torch.randn(2, 4, 5, 9, device=dev)),
                            rg(torch.rand(2, 4, 5, device=dev)))
    sm = K.segment_max(rg(y), seg, valid, 6)
    gc = K.gather_concat(rg(y), rg(pooled), seg, relu=True)
    gn = K.masked_group_norm(rg(x), mask, 4, rg(w), rg(b), relu=True)
    sc, _ = K.scatter_anchors_to_dense(rg(torch.randn(64, 8, device=dev)),
                                       vg, (8, 8, 8), 1)
    ts = trilinear_sample_scale(rg(grid), q, c0, 0.5)
    made = (v, d, p, sm, gc, gn, sc, ts)
    for t in made:
        assert t.grad_fn is not None
    sum(t.sum() for t in made).backward()
    torch.cuda.synchronize()
    counts = K.launch_counts()
    for k in ("source_variance", "softargmax_depth", "propagation_blend",
              "segment_max", "gather_concat", "masked_group_norm",
              "scatter_anchors_to_dense", "trilinear_sample"):
        assert counts[k] == counts[k + "_backward"] == 1, k
    # without grad mode nothing raises
    with torch.inference_mode():
        for call in raising.values():
            call()


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu():
    """One tiny n_iters=0 train step from the same weights on the card and
    on the CPU: loss, every gradient and the parameters after Adam."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import copy

    from tdvnet_torch.config import tiny_test_config
    from tdvnet_torch.data import batch as B, synthetic
    from tdvnet_torch.kernels import launch_counts, reset_launch_counts
    from tdvnet_torch.models.threedvnet import ThreeDVNet
    from tdvnet_torch.train import loop as L

    cfg = tiny_test_config()
    bc = cfg.batch
    batch = B.collate_scenes(
        [synthetic.make_batch_scene(bc.n_views, bc.img_size,
                                    bc.depth_img_size, seed=0)],
        bc.n_views, bc.n_ref, bc.n_src_on_either_side)
    torch.manual_seed(0)
    cpu = ThreeDVNet(cfg.model)
    card = copy.deepcopy(cpu).cuda()
    out = {}
    for name, m in (("cpu", cpu), ("cuda", card)):
        st = L.TrainState(m, L.make_optimizer(cfg, m, 1))
        reset_launch_counts()
        with torch.backends.mkldnn.flags(enabled=False):
            _, mets = L.make_train_step(m, cfg, 0)(st, batch, 0.0)
        out[name] = (float(mets["loss"]), {
            k: p.grad.double().cpu() for k, p in m.named_parameters()
            if p.grad is not None}, launch_counts())
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4 * abs(out["cpu"][0])
    counts = out["cuda"][2]
    assert counts["source_variance_backward"] == 1
    assert counts["softargmax_depth_backward"] == 1
    assert counts["propagation_blend_backward"] == 3
    worst = {}
    for k, a in out["cuda"][1].items():
        b = out["cpu"][1][k]
        worst[k] = float((a - b).norm() / b.norm().clamp(min=1e-12))
    worst.pop("mvsnet.cost_reg.Conv_0.bias")      # zero in exact arithmetic
    bad = {k: v for k, v in worst.items() if v > 1e-3}
    assert not bad, bad


@pytest.mark.cuda
@pytest.mark.parametrize("n_iters", [1, 2])
def test_refinement_train_step_on_the_card_matches_the_cpu(n_iters):
    """One tiny n_iters >= 1 train step from the same weights on the card
    and on the CPU in float64 through the twins (`chip_smoke.float64_twins`):
    loss and every gradient, and from the launch counters every kernel of
    the path, forward and backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import copy
    import dataclasses

    import chip_smoke
    from tdvnet_torch.config import tiny_test_config
    from tdvnet_torch.data import batch as B, synthetic
    from tdvnet_torch.kernels import launch_counts, reset_launch_counts
    from tdvnet_torch.models.threedvnet import ThreeDVNet
    from tdvnet_torch.train import loop as L

    cfg = tiny_test_config()
    bc = cfg.batch
    batch = B.collate_scenes(
        [synthetic.make_batch_scene(bc.n_views, bc.img_size,
                                    bc.depth_img_size, seed=0)],
        bc.n_views, bc.n_ref, bc.n_src_on_either_side)
    torch.manual_seed(0)
    f64 = ThreeDVNet(cfg.model)
    card = copy.deepcopy(f64).cuda()
    st = L.TrainState(card, L.make_optimizer(cfg, card, 1))
    reset_launch_counts()
    _, mets = L.make_train_step(card, cfg, n_iters)(st, batch, 0.5)
    counts = launch_counts()
    f64 = f64.double().train()
    b64 = dataclasses.replace(batch, images=batch.images.double(),
                              depth_gt=batch.depth_gt.double())
    with torch.backends.mkldnn.flags(enabled=False), \
            chip_smoke.float64_twins():
        out = f64(b64, list(cfg.train.offsets), n_iters, 0.5,
                  with_metrics=False, backbone_train=False)
        out["loss"].backward()
    want = float(out["loss"])
    assert abs(float(mets["loss"]) - want) <= 1e-5 * abs(want)
    assert counts == chip_smoke.train_expected_launches(
        1, n_iters, len(cfg.train.offsets), cfg.model.unet_res)
    # cuDNN's train-mode BatchNorm backward in the PropagationNets, whose
    # sums cancel at this size, puts refine_half's BatchNorm and the FPN's
    # half-scale head that guides it up to 5.4e-3 off (refine_full's
    # 4.6e-4), where the scene stages' leaves are within 1e-4
    loose = ("refine_", "mvsnet.fpn.lateral0.", "mvsnet.fpn.smooth0.")
    bad = {}
    for k, p in f64.named_parameters():
        g = card.get_parameter(k).grad
        # the frozen backbone BatchNorm leaves take no gradient on the card
        if g is None or p.grad is None or k in chip_smoke.ZERO_GRADS:
            continue
        g = g.double().cpu()
        e = float((g - p.grad).norm() / p.grad.norm().clamp(min=1e-12))
        if e > (1e-2 if k.startswith(loose) else 1e-3):
            bad[k] = e
    assert not bad, sorted(bad.items(), key=lambda kv: -kv[1])[:10]


@pytest.mark.cuda
def test_scene_wrappers_give_their_twins_gradients_on_the_card():
    """Each new hand backward through its `autograd.Function` on CUDA
    tensors against torch.autograd of the twin on the CPU, on small
    inputs with ties, empty segments, all three GroupNorm tails and
    points outside the grid."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from tdvnet_torch import kernels as K
    from tdvnet_torch.kernels.trilinear import trilinear_sample_scale

    g = torch.Generator().manual_seed(5)
    r = lambda *s: torch.randn(*s, generator=g)

    def both(fn, *args, grads):
        """fn's gradients for args[i] in `grads` with CPU and CUDA
        tensors."""
        res = []
        for dev in ("cpu", "cuda"):
            a = [x.to(dev) if torch.is_tensor(x) else x for x in args]
            a = [x.clone().requires_grad_() if i in grads else x
                 for i, x in enumerate(a)]
            o = fn(*a)
            o = o[0] if isinstance(o, tuple) else o
            w = torch.randn(o.shape, generator=torch.Generator()
                            .manual_seed(6)).to(dev)
            res.append(torch.autograd.grad((o * w).sum(),
                                           [a[i] for i in grads]))
        for x, y in zip(*res):
            assert torch.allclose(x, y.cpu(), rtol=1e-5, atol=1e-5), fn

    pts = torch.rand(300, 3, generator=g) * 1.5 - 0.1
    vg = K.voxelize_points(pts, torch.arange(300) // 150,
                           torch.rand(300, generator=g) > 0.1, 0.08,
                           (16, 16, 16), 64, 2)
    vgc = type(vg)(*[x.cuda() if torch.is_tensor(x) else x for x in vg])
    y = r(300, 8)
    y[:2] = y[2]                            # a tie in a shared segment
    seg, valid = vg.point2anchor, vg.point_valid
    both(lambda yy, s, v: K.segment_max(yy, s, v, 66), y, seg, valid,
         grads=[0])
    pooled = K.segment_max(y, seg, valid, 66)
    both(lambda yy, pp, s: K.gather_concat(yy, pp, s, relu=True), y, pooled,
         seg, grads=[0, 1])
    both(lambda f: K.scatter_anchors_to_dense(
        f, vgc if f.is_cuda else vg, (16, 16, 16), 2), r(64, 8), grads=[0])
    x = r(2, 8, 3, 4, 5)
    m = (torch.rand(2, 1, 3, 4, 5, generator=g) > 0.5).float()
    for kw in ({}, {"relu": True}):
        both(lambda xx, ww, bb, mm=m, kw=kw: K.masked_group_norm(
            xx, mm.to(xx.device), 4, ww, bb, **kw), x * m, r(8), r(8),
            grads=[0, 1, 2])
    both(lambda xx, ww, bb, ss, mm=m: K.masked_group_norm(
        xx, mm.to(xx.device), 4, ww, bb, skip=ss), x * m, r(8), r(8),
        r(2, 8, 3, 4, 5) * m, grads=[0, 1, 2, 3])
    grid = r(2, 4, 5, 6, 8)
    q = torch.rand(2, 40, 3, generator=g) * 4 - 1    # some outside
    c0 = r(2, 3) * 0.1
    both(lambda gr, qq, cc: trilinear_sample_scale(gr, qq, cc, 0.5), grid,
         q, c0, grads=[0])


@pytest.mark.cuda
def test_probe_kernels_match_twins():
    """batched_dot at the probe's shape and the ragged ones within one bf16
    ulp of its twin, and refusing other shapes; take_along_axis on the
    tool's cases and on out-of-range indices equal to its twin (NaN
    positions included, jnp.take_along_axis's rule) without a host sync."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from tdvnet_torch.kernels.probes import (batched_dot, batched_dot_ref,
                                             take_along_axis,
                                             take_along_axis_ref)
    from tdvnet_torch.tools import probe_batched_dot, probe_gather
    from tdvnet_torch.tools.timing import bf16_ulp_ok

    dev = torch.device("cuda")
    W, F = probe_batched_dot.make_inputs(dev, 4, 5)
    assert bf16_ulp_ok(batched_dot(W, F), batched_dot_ref(W, F))
    for lead, Q, Y, C in probe_batched_dot.RAGGED:
        W, F = probe_batched_dot.make_shaped(dev, lead, Q, Y, C, seed=9)
        assert bf16_ulp_ok(batched_dot(W, F), batched_dot_ref(W, F)), (
            lead, Q, Y, C)
    W, F = probe_batched_dot.make_shaped(dev, (3,), 56, 48, 32)
    with pytest.raises(ValueError):
        batched_dot(W, F)
    for name, axis, vals, idx in probe_gather.make_inputs():
        v, i = torch.from_numpy(vals).cuda(), torch.from_numpy(idx).cuda()
        assert torch.equal(take_along_axis(v, i, axis),
                           take_along_axis_ref(v, i, axis)), name
    for name, axis, vals, idx in probe_gather.out_of_range_inputs():
        v, i = torch.from_numpy(vals).cuda(), torch.from_numpy(idx).cuda()
        got, want = take_along_axis(v, i, axis), take_along_axis_ref(v, i,
                                                                     axis)
        assert got.isnan().any(), name
        assert torch.equal(got.isnan(), want.isnan()), name
        assert torch.equal(got.nan_to_num(), want.nan_to_num()), name
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):
            int(i.min())                    # the control: a host sync
        take_along_axis(v, i, axis)
    finally:
        torch.cuda.set_sync_debug_mode(0)


# ---------------------------------- the brick backward and the dense scatter
def _leave_nan(shape, device):
    """Free a block of NaN of `shape` fp32 into the caching allocator, where
    the next allocation of that size lands: an output element that a
    kernel leaves unwritten then reads NaN."""
    torch.full(shape, float("nan"), device=device)


def _tri_inputs(case, device):
    import _kernel_edge_cases as E

    grad, pts, c0, cell, shape = E.trilinear_case(case)
    return ([torch.from_numpy(x).to(device) for x in (grad, pts, c0)], cell,
            shape)


def _tri_referee(grad, pts, c0, cell, shape):
    """The twin over float64 copies of grad and pts, rounded to fp32: the
    edge inputs' coordinates and weights are exact in either type, and a
    float64 sum of ~120000 crowded terms lands on one fp32 value whatever
    order the card's `index_add_` takes (an fp32 twin moved by up to 1.25e-5
    of the largest magnitude from run to run)."""
    from tdvnet_torch.kernels import trilinear as T

    return T.trilinear_sample_backward_ref(grad.double(), pts.double(), c0,
                                           cell, shape).float()


def _tri_check(got, want):
    import chip_smoke

    assert got.shape == want.shape and torch.isfinite(got).all()
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max()) if got.numel() else 0.0
    # the reading, for `pytest -s` runs that track it
    print(f"K6 grid backward: max |d| {err / scale:.3e} of the twin's "
          f"scale (limit {chip_smoke.BACKWARD_TOL})")
    assert err <= chip_smoke.BACKWARD_TOL * scale, err


# the kernel sums a brick's entries in chunks of 1024 to 4096, sized from
# the point count and the card: a brick of at most ONE_CHUNK entries is one
# chunk, which stores its tile once; one of more than SEVERAL_CHUNKS is
# several, which add into the zeroed brick with vector reductions
ONE_CHUNK, SEVERAL_CHUNKS = 1024, 4096


def _brick_entries(pts, c0, cell, shape):
    """[n_bricks] the binning's entries per brick: one per (point, brick
    that holds one of its in-grid taps), as the kernel counts them."""
    from tdvnet_torch.kernels.trilinear import BRICK, brick_count

    B, X, Y, Z, _ = shape
    n = torch.tensor((X, Y, Z))
    q = (pts.cpu() - c0.cpu()[:, None]) / torch.tensor(cell)
    f = q.floor()
    ok = torch.isfinite(q).all(-1) & ((f >= -1) & (f <= n - 1)).all(-1)
    f = torch.where(ok[..., None], f, torch.zeros_like(f)).long()
    lo = f.clamp(min=0) // BRICK
    hi = torch.minimum(f + 1, n - 1) // BRICK
    nb = [-(-int(d) // BRICK) for d in n]
    scene = torch.arange(B)[:, None].expand(ok.shape)
    counts = torch.zeros(brick_count(shape), dtype=torch.long)
    for pick in np.ndindex(2, 2, 2):
        k = [hi[..., a] if pick[a] else lo[..., a] for a in range(3)]
        take = ok.clone()
        for a in range(3):
            if pick[a]:
                take &= hi[..., a] != lo[..., a]
        ids = ((scene * nb[0] + k[0]) * nb[1] + k[1]) * nb[2] + k[2]
        counts.index_add_(0, ids[take], torch.ones_like(ids[take]))
    return counts


@pytest.mark.cuda
@pytest.mark.parametrize("crowded", [False, True])
@pytest.mark.parametrize("case", ["brick_faces", "grid_edges", "nonfinite",
                                  "one_cell", "no_points", "four_channels"])
def test_trilinear_backward_kernel_matches_twin_at_edges(case, crowded):
    """The brick-binned backward against its twin at
    `tests/_kernel_edge_cases.py`'s edges (partial bricks at the grid's
    high faces, anchors on brick faces and corners, on the last node and at
    -1, non-finite points, one crowded cell, no points, four channels), as
    they are and crowded: each point repeated to about 120000 a scene with
    gradient rows of its own, so that the busiest brick holds several
    chunks and adds them into a zeroed output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from tdvnet_torch.kernels import trilinear as T

    dev = torch.device("cuda")
    (grad, pts, c0), cell, shape = _tri_inputs(case, dev)
    Q = pts.shape[1]
    if crowded and Q:
        reps = -(-120000 // Q)
        pts = pts.repeat(1, reps, 1)
        grad = torch.randn(grad.shape[0], Q * reps, grad.shape[2],
                           generator=torch.Generator().manual_seed(3)).to(dev)
    counts = _brick_entries(pts, c0, cell, shape)
    if crowded and Q:
        assert int(counts.max()) > SEVERAL_CHUNKS
    _leave_nan(shape, dev)
    got = T.trilinear_sample_backward(grad, pts, c0, cell, shape)
    want = _tri_referee(grad, pts, c0, cell, shape)
    torch.cuda.synchronize()
    _tri_check(got, want)
    if case == "no_points":
        assert not got.any()


def _uniform_points(B, Q, dims, cell, seed):
    """World points uniform over a grid of `dims` nodes and a margin of a
    cell around it, with node 0 at the origin."""
    g = torch.Generator().manual_seed(seed)
    lo, span = -cell, (torch.tensor(dims, dtype=torch.float32) + 1) * cell
    return lo + torch.rand(B, Q, 3, generator=g) * span, torch.zeros(B, 3)


def _tri_uniform_check(B, Q, C, dims, cell, seed):
    """The kernel against its twin on uniform points and normal incoming
    gradients at [B, dims, C], its output landing in a block of NaN.
    Returns the entries per brick."""
    from tdvnet_torch.kernels import trilinear as T

    dev = torch.device("cuda")
    pts, c0 = _uniform_points(B, Q, dims, cell, seed)
    grad = torch.randn(B, Q, C,
                       generator=torch.Generator().manual_seed(seed + 1))
    counts = _brick_entries(pts, c0, cell, (B, *dims, C))
    pts, c0, grad = pts.to(dev), c0.to(dev), grad.to(dev)
    shape = (B, *dims, C)
    _leave_nan(shape, dev)
    got = T.trilinear_sample_backward(grad, pts, c0, cell, shape)
    want = T.trilinear_sample_backward_ref(grad, pts, c0, cell, shape)
    torch.cuda.synchronize()
    _tri_check(got, want)
    return counts, got


@pytest.mark.cuda
def test_trilinear_backward_kernel_adds_chunks_at_the_coarse_scale():
    """The full-width step's coarsest scale ([2, 16^3, 128], 153664
    hypotheses a scene): every brick's list splits into several chunks that
    add into the zeroed bricks with vector reductions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    counts, _ = _tri_uniform_check(2, 153664, 128, (16, 16, 16), 0.32, 4)
    assert int(counts.min()) > SEVERAL_CHUNKS


@pytest.mark.cuda
def test_trilinear_backward_kernel_stores_once_at_the_fine_scale():
    """The finest scale's grid ([2, 64^3, 64]) under 20000 points a scene:
    every brick is one chunk and stores its tile once, zeros included,
    into an uninitialised output (no zero fill, no global atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    counts, got = _tri_uniform_check(2, 20000, 64, (64, 64, 64), 0.08, 6)
    assert int(counts.max()) <= ONE_CHUNK
    assert (got == 0).float().mean() > 0.5      # most nodes took nothing


@pytest.mark.cuda
def test_trilinear_backward_kernel_bins_past_the_shared_histogram():
    """Four scenes of 128^3 nodes are 16384 bricks, more than a bin block's
    shared histogram holds (12288): the binning then takes one global
    atomic per entry."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from tdvnet_torch.kernels.trilinear import brick_count

    dims = (128, 128, 128)
    assert brick_count((4, *dims, 4)) == 16384
    _tri_uniform_check(4, 200000, 4, dims, 0.04, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("shuffled", [False, True])
@pytest.mark.parametrize("case", ["no_valid", "all_valid", "last_cells",
                                  "three_scenes"])
def test_scatter_kernel_equals_twin_at_edges(case, shuffled):
    """The map-based scatter writes every element of `dense` and `occ` once
    (into blocks of NaN left by `_leave_nan`), reads a map entry that names
    an anchor of another cell as no anchor, and equals its twin bit for
    bit: no valid anchor, every anchor valid, anchors in each scene's last
    cell, three scenes; in `voxelize`'s order and shuffled (the kernel
    assumes none)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    _scatter_check(case, shuffled)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [4, 12, 136, 256])
def test_scatter_kernel_equals_twin_at_channel_widths(width):
    """The scatter at other row widths than the edge cases' 8 channels:
    one 16-byte quad a cell (4), an odd count of quads (12, 136) and rows
    longer than a warp's stores (256)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    _scatter_check("three_scenes", True, width)


def _scatter_check(case, shuffled, width=None):
    """The scatter against its twin bit for bit on `case`'s anchor table
    (features `width` wide when given), its outputs landing in blocks of NaN
    and of wrong anchor names."""
    import _kernel_edge_cases as E
    from tdvnet_torch.kernels import voxelize as vox

    dev = torch.device("cuda")
    feats, idx3, scene, valid, grid, B = E.scatter_case(case)
    if width is not None:
        feats = np.random.default_rng(width).normal(
            size=(len(valid), width)).astype(np.float32)
    if shuffled:
        perm = np.random.default_rng(1).permutation(len(valid))
        feats, idx3, scene, valid = (x[perm] for x in (feats, idx3, scene,
                                                        valid))
    feats = torch.from_numpy(np.ascontiguousarray(feats)).to(dev)
    vg = vox._anchor_table(*(torch.from_numpy(np.ascontiguousarray(x))
                             .to(dev) for x in (idx3, scene, valid)))
    _leave_nan((B, *grid, feats.shape[1]), dev)
    # the cell map is never filled: leave blocks of its size whose every
    # entry names an anchor (i mod A), mostly of another cell
    n_all, A = B * grid[0] * grid[1] * grid[2], len(valid)
    names = [torch.arange(n_all, dtype=torch.int32, device=dev) % A
             for _ in range(2)]
    del names
    got = vox.scatter_anchors_to_dense(feats, vg, grid, B)
    want = vox.scatter_anchors_to_dense_ref(feats, vg, grid, B)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[1].sum()) == int(valid.sum())


# ------------------------------------------------------ the variance kernels
def _variance_inputs(case, device):
    import _kernel_edge_cases as E

    P_all = E.projection_matrices(case["K"], case["rotmats"], case["tvecs"])
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                 for x in (case["pts"], case["feats"], case["src_idx"],
                           case["src_mask"], P_all)) + (case["img_size"],)


def _variance_check(got, want, tol):
    """NaN where the twin is NaN, elsewhere within `tol` of the twin's
    largest magnitude (at least 1)."""
    assert got.shape == want.shape
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    fin = ~nan
    scale = max(1.0, float(want[fin].abs().max())) if fin.any() else 1.0
    err = float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0
    assert err <= tol * scale, err


@pytest.mark.cuda
@pytest.mark.parametrize("C", [4, 8, 12, 32, 64, 1040])
@pytest.mark.parametrize("name", ["scattered", "edges", "nonfinite",
                                  "ragged"])
def test_source_variance_kernel_matches_twin_at_edges(name, C):
    """K1's kernel against its twin on the edge inputs, variance and mean,
    within 1e-4 of the twin's largest, NaN for NaN; C = 12 puts a point's
    channel groups across warps (each lane projects its own sources), and
    C = 1040 takes two blocks along the channels, the second partial."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import _kernel_edge_cases as E
    from tdvnet_torch.kernels import variance as K

    args = _variance_inputs(E.variance_case(name, C), "cuda")
    got = K._source_variance(*args, True)
    want = K.source_variance_ref(*(a.cpu() if torch.is_tensor(a) else a
                                   for a in args), with_mean=True)
    for g, w in zip(got, want):
        _variance_check(g.cpu(), w, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shared,own", [(8, 12), (16, 24), (32, 48),
                                        (64, 80), (1040, 1020)])
@pytest.mark.parametrize("name", ["scattered", "nonfinite"])
def test_source_variance_shared_projection_is_bit_equal(name, shared, own):
    """K1's lanes that share a point's projection through warp shuffles
    (C = `shared`: 2 to 32 lanes a point) give the same bits as lanes that
    each project their own point (C = `own`: C/4 neither divides 32 nor is
    a multiple of it), variance and mean, on the first min(C) channels of
    the same maps. Training's referee readings follow any rounding change,
    so the shared form must not round differently."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import _kernel_edge_cases as E
    from tdvnet_torch.kernels import variance as K

    pts, feats, *rest = _variance_inputs(
        E.variance_case(name, max(shared, own)), "cuda")
    n = min(shared, own)
    got = {c: K._source_variance(pts, feats[..., :c].contiguous(), *rest,
                                 True) for c in (shared, own)}
    for a, b in zip(got[shared], got[own]):
        a, b = a[..., :n], b[..., :n]
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
    if name == "nonfinite":
        assert torch.isnan(got[own][0]).any()


@pytest.mark.cuda
@pytest.mark.parametrize("C", [4, 6, 8, 32, 64])
@pytest.mark.parametrize("name", ["scattered", "edges", "wide", "nonfinite",
                                  "single", "eight"])
def test_patch_fan_variance_kernel_matches_twin_at_edges(name, C):
    """K7's tiled kernel against its twin on the edge inputs (centres
    scattered and off the map, Hh = 1 and 8, C % 4 != 0), within 1e-5 of
    the twin's largest, NaN for NaN."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import _kernel_edge_cases as E
    from tdvnet_torch.kernels.patchfan import (patch_fan_variance,
                                               patch_fan_variance_ref)

    args = _variance_inputs(E.fan_case(name, C), "cuda")
    got = patch_fan_variance(*args)
    want = patch_fan_variance_ref(*(a.cpu() if torch.is_tensor(a) else a
                                    for a in args))
    _variance_check(got.cpu(), want, 1e-5)


# ------------------------------ the sampling forward and the GroupNorm forward
def _tri_forward(case, C, device):
    import _kernel_edge_cases as E

    return [torch.from_numpy(a).to(device) if isinstance(a, np.ndarray)
            else a for a in E.trilinear_forward_case(case, C)]


def _same_bits(a, b):
    """Equal bit for bit, NaN included."""
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [4, 12, 64, 128, 256])
@pytest.mark.parametrize("case", ["brick_faces", "grid_edges", "nonfinite",
                                  "one_cell", "no_points", "four_channels",
                                  "anchor_runs", "alternating", "ragged"])
def test_trilinear_forward_kernel_matches_twin_at_edges(case, C):
    """K6's forward against its twin on the edge inputs, written into a
    channel slice of a wider output whose other channels stay untouched:
    within 1e-5 of the twin's largest, NaN for NaN. C = 12 leaves a lane of
    every four idle, C = 256 walks the channels in two slices of 128."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from tdvnet_torch.kernels.trilinear import (trilinear_sample,
                                                trilinear_sample_ref)

    grid, pts, c0, cell = _tri_forward(case, C, "cuda")
    B, Q = pts.shape[:2]
    out = torch.full((B, Q, C + 8), 7.0, device="cuda")
    trilinear_sample(grid, pts, c0, cell, out, 4)
    want = trilinear_sample_ref(grid.cpu(), pts.cpu(), c0.cpu(), cell)
    got = out[..., 4:4 + C].cpu()
    assert (out[..., :4] == 7).all() and (out[..., 4 + C:] == 7).all()
    _variance_check(got, want, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [4, 64, 128])
@pytest.mark.parametrize("case", ["anchor_runs", "alternating", "ragged",
                                  "grid_edges", "nonfinite"])
def test_trilinear_forward_does_not_depend_on_anchor_runs(case, C):
    """Each query's samples are the same bits whether its neighbours share
    its anchor (the kernel then keeps the taps it holds) or not: the
    queries sampled in a shuffled order, un-shuffled, equal the samples in
    their own order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from tdvnet_torch.kernels.trilinear import trilinear_sample

    grid, pts, c0, cell = _tri_forward(case, C, "cuda")
    B, Q = pts.shape[:2]
    perm = torch.randperm(Q, generator=torch.Generator().manual_seed(3))
    perm = perm.to("cuda")
    a = trilinear_sample(grid, pts, c0, cell,
                         torch.empty(B, Q, C, device="cuda"), 0)
    b = trilinear_sample(grid, pts[:, perm].contiguous(), c0, cell,
                         torch.empty(B, Q, C, device="cuda"), 0)
    back = torch.empty_like(b)
    back[:, perm] = b
    assert _same_bits(a, back)


def _gn_inputs(name, C, G, device):
    import _kernel_edge_cases as E

    x, mask, skip, w, b, G = E.gn_case(name, C, G)
    return [torch.from_numpy(a).to(device) for a in (x, mask, skip, w, b)] \
        + [G]


@pytest.mark.cuda
@pytest.mark.parametrize("C,G", [(8, 2), (64, 4), (128, 8)])
@pytest.mark.parametrize("name", ["one_voxel", "ragged", "level2", "level1",
                                  "level0", "one_active", "empty",
                                  "two_counts", "large_mean"])
def test_masked_group_norm_kernel_matches_twin_at_edges(name, C, G):
    """K5's forward against its twin on the edge inputs, at the CPU tests'
    width and at the U-Net's (C/G = 16), in the three tails: within 1e-4 of
    the twin's largest (the float64 sums run in another order), zero where
    the mask is, the same bits when called again (a fixed reduction order,
    whichever statistics block finishes last), and statistics (mean, rstd)
    within one fp32 ulp of the float64 twin's, counts equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from tdvnet_torch.kernels import groupnorm as K

    x, mask, skip, w, b, G = _gn_inputs(name, C, G, "cuda")
    B = x.shape[0]
    for kw in ({}, {"relu": True}, {"skip": skip}):
        got, stats = K._masked_group_norm(x, mask, G, w, b, 1e-5,
                                          kw.get("relu", False),
                                          kw.get("skip"))
        want = K.masked_group_norm_ref(x.cpu(), mask.cpu(), G, w.cpu(),
                                       b.cpu(), **{k: v.cpu() if
                                                   torch.is_tensor(v) else v
                                                   for k, v in kw.items()})
        tol = 1e-4 * max(1.0, float(want.abs().max()))
        assert float((got.cpu() - want).abs().max()) <= tol, list(kw)
        assert not (got * (1 - mask)).any()
        again, stats2 = K._masked_group_norm(x, mask, G, w, b, 1e-5,
                                             kw.get("relu", False),
                                             kw.get("skip"))
        assert _same_bits(got, again) and _same_bits(stats, stats2)
    _, mean, var, cnt = K._group_stats(x.cpu().double(), mask.cpu(), G)
    rstd = torch.rsqrt(var.clamp(min=0.0) + 1e-5)
    ref = torch.stack([mean.reshape(-1), rstd.reshape(-1)], -1).float()
    bits = lambda a: a.contiguous().view(torch.int32).long()
    assert int((bits(stats[:, :2].cpu()) - bits(ref)).abs().max()) <= 1
    assert torch.equal(stats[:, 2].cpu(),
                       cnt.expand(B, G).reshape(-1).float())


# --------------------------------------------- order-free backward sums
# K1/K2's, K6's and the concat-back's backward kernels sum in fixed point
# (csrc/fixed_sum.cuh) and K5's in a fixed order: each must give the same
# bits on a second launch and, where the sum runs over points, with the
# points shuffled; a NaN or an Inf in the incoming gradient must come out
# where the twin's float sum puts it.
def _poison(g, seed):
    """A copy of g with a NaN, a +Inf and a -Inf at seeded places."""
    g = g.clone()
    flat = g.view(-1)
    if flat.numel() < 3:
        return g
    i = torch.randperm(flat.numel(),
                       generator=torch.Generator().manual_seed(seed))[:3]
    for j, v in zip(i.tolist(), (float("nan"), float("inf"),
                                 float("-inf"))):
        flat[j] = v
    return g


def _nonfinite_check(got, want, tol):
    """NaN and each signed Inf where the twin has them; elsewhere within
    `tol` of the twin's largest finite magnitude (at least 1)."""
    got, want = got.cpu(), want.cpu()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isposinf(got), torch.isposinf(want))
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    if fin.any():
        scale = max(1.0, float(want[fin].abs().max()))
        assert float((got[fin] - want[fin]).abs().max()) <= tol * scale


def _perm(n, device, seed=5):
    return torch.randperm(n, generator=torch.Generator().manual_seed(
        seed)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [4, 12, 32, 64])
@pytest.mark.parametrize("name", ["scattered", "edges", "nonfinite",
                                  "ragged"])
def test_source_variance_backward_is_order_free_at_edges(name, C):
    """K1's backward against its twin on the edge inputs (NaN for NaN,
    within the variance backward's tolerance), and the same bits on a
    second launch, with the points shuffled and with the points tiled as
    planes of pixels; a non-finite incoming gradient gives the twin's
    non-finite pattern. C = 12 shares no projections across lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import _kernel_edge_cases as E
    import chip_smoke
    from tdvnet_torch.kernels import variance as K

    pts, feats, sidx, smask, P_all, img = _variance_inputs(
        E.variance_case(name, C), "cuda")
    _, mean = K._source_variance(pts, feats, sidx, smask, P_all, img, True)
    R, P = pts.shape[:2]
    grad = torch.randn(R, P, C, generator=torch.Generator().manual_seed(
        1)).cuda()
    cpu = lambda *a: tuple(x.cpu() if torch.is_tensor(x) else x for x in a)
    rest = (sidx, smask, P_all, img)
    tol = chip_smoke.VARIANCE_BACKWARD_TOL
    got = K.source_variance_backward(grad, mean, pts, feats, *rest, (1, P))
    want = K.source_variance_backward_ref(*cpu(grad, mean, pts, feats,
                                               *rest))
    _variance_check(got.cpu(), want, tol)
    assert _same_bits(got, K.source_variance_backward(grad, mean, pts,
                                                      feats, *rest, (1, P)))
    assert _same_bits(got, K.source_variance_backward(
        grad, mean, pts, feats, *rest, (1, max(P // 3, 1))))
    assert _same_bits(got, K.source_variance_backward(
        grad, mean, pts, feats, *rest, (3, max(P // 9, 1))))
    i = _perm(P, "cuda")
    shuf = K.source_variance_backward(
        grad[:, i].contiguous(), mean[:, i].contiguous(),
        pts[:, i].contiguous(), feats, *rest, (1, P))
    assert _same_bits(got, shuf)
    bad = _poison(grad, 2)
    _nonfinite_check(K.source_variance_backward(bad, mean, pts, feats,
                                                *rest, (1, P)),
                     K.source_variance_backward_ref(
                         *cpu(bad, mean, pts, feats, *rest)), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("crowded", [False, True])
@pytest.mark.parametrize("case", ["brick_faces", "grid_edges", "nonfinite",
                                  "one_cell", "no_points", "four_channels"])
def test_trilinear_backward_is_order_free_at_edges(case, crowded):
    """K6's grid backward on the edge inputs, as they are and crowded into
    bricks of several chunks (which add into an int64 copy of the brick):
    the same bits on a second launch and with the points shuffled, and a
    non-finite incoming gradient gives the twin's non-finite pattern. The
    twin runs in float64 (`_tri_referee`), so that its own sum does not
    move with the order of the card's atomics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import chip_smoke
    from tdvnet_torch.kernels import trilinear as T

    dev = torch.device("cuda")
    (grad, pts, c0), cell, shape = _tri_inputs(case, dev)
    Q = pts.shape[1]
    if crowded and Q:
        reps = -(-120000 // Q)
        pts = pts.repeat(1, reps, 1)
        grad = torch.randn(grad.shape[0], Q * reps, grad.shape[2],
                           generator=torch.Generator().manual_seed(3)).to(dev)
        Q = pts.shape[1]
    got = T.trilinear_sample_backward(grad, pts, c0, cell, shape)
    _tri_check(got, _tri_referee(grad, pts, c0, cell, shape))
    assert _same_bits(got, T.trilinear_sample_backward(grad, pts, c0, cell,
                                                       shape))
    i = _perm(Q, dev)
    assert _same_bits(got, T.trilinear_sample_backward(
        grad[:, i].contiguous(), pts[:, i].contiguous(), c0, cell, shape))
    bad = _poison(grad, 4)
    _nonfinite_check(T.trilinear_sample_backward(bad, pts, c0, cell, shape),
                     _tri_referee(bad, pts, c0, cell, shape),
                     chip_smoke.BACKWARD_TOL)


def _concat_case(P, C, n_seg, seed, device):
    g = torch.Generator().manual_seed(seed)
    y = torch.randn(P, C, generator=g)
    # a few segments hold most rows, some none
    seg = torch.randint(0, n_seg, (P,), generator=g)
    seg[: P // 2] = torch.randint(0, 3, (P // 2,), generator=g)
    pooled = torch.randn(n_seg, C, generator=g)
    grad = torch.randn(P, 2 * C, generator=g)
    return [t.to(device) for t in (grad, y, pooled, seg)]


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("P,C,n_seg", [(1, 4, 1), (37, 8, 9),
                                       (5000, 128, 700)])
def test_concat_back_is_order_free(P, C, n_seg, relu):
    """K4's concat-back against its twin: its segment sum in fixed point is
    the same bits on a second launch and with the rows shuffled, and a
    non-finite incoming gradient gives the twin's non-finite pattern."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import chip_smoke
    from tdvnet_torch.kernels import segmax as K

    grad, y, pooled, seg = _concat_case(P, C, n_seg, 7, "cuda")
    tol = chip_smoke.ATOMIC_BACKWARD_TOL
    gy, gp = K.gather_concat_backward(grad, y, pooled, seg, relu)
    wy, wp = K.gather_concat_backward_ref(grad.cpu(), y.cpu(), pooled.cpu(),
                                          seg.cpu(), relu)
    assert torch.equal(gy.cpu(), wy)
    _nonfinite_check(gp, wp, tol)
    gy2, gp2 = K.gather_concat_backward(grad, y, pooled, seg, relu)
    assert _same_bits(gy, gy2) and _same_bits(gp, gp2)
    i = _perm(P, "cuda")
    gy3, gp3 = K.gather_concat_backward(grad[i], y[i], pooled, seg[i], relu)
    assert _same_bits(gp, gp3) and _same_bits(gy[i], gy3)
    bad = _poison(grad, 6)
    _nonfinite_check(K.gather_concat_backward(bad, y, pooled, seg, relu)[1],
                     K.gather_concat_backward_ref(bad.cpu(), y.cpu(),
                                                  pooled.cpu(), seg.cpu(),
                                                  relu)[1], tol)


@pytest.mark.cuda
@pytest.mark.parametrize("C,G", [(8, 2), (64, 4), (128, 8)])
@pytest.mark.parametrize("name", ["one_voxel", "ragged", "level2", "level1",
                                  "level0", "one_active", "empty",
                                  "two_counts", "large_mean"])
def test_masked_group_norm_backward_repeats_at_edges(name, C, G):
    """K5's one-launch backward against its twin on the edge inputs (the
    three U-Net level sizes among them) in the three tails: within
    BACKWARD_TOL of the twin's largest, the same bits on a second launch,
    and a non-finite incoming gradient gives the twin's non-finite
    pattern."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import chip_smoke
    from tdvnet_torch.kernels import groupnorm as K

    x, mask, skip, w, b, G = _gn_inputs(name, C, G, "cuda")
    grad = torch.randn(x.shape, generator=torch.Generator().manual_seed(
        8)).cuda()
    tol = chip_smoke.BACKWARD_TOL
    for tail, kw in (("none", {}), ("relu", {"relu": True}),
                     ("skip", {"skip": skip})):
        relu, sk = kw.get("relu", False), kw.get("skip")
        out, stats = K._masked_group_norm(x, mask, G, w, b, 1e-5, relu, sk)
        args = (x, mask, G, w, out, stats, 1e-5, relu, sk is not None)
        got = K.masked_group_norm_backward(grad, *args, bias=b)
        want = K.masked_group_norm_backward_ref(
            grad.cpu(), x.cpu(), mask.cpu(), G, w.cpu(), out.cpu(), 1e-5,
            relu, sk is not None)
        for a, c in zip(got, want):
            if c is not None:
                _nonfinite_check(a, c, tol)
        again = K.masked_group_norm_backward(grad, *args, bias=b)
        for a, c in zip(got, again):
            if a is not None:
                assert _same_bits(a, c), tail
        bad = _poison(grad, 9)
        got = K.masked_group_norm_backward(bad, *args, bias=b)
        want = K.masked_group_norm_backward_ref(
            bad.cpu(), x.cpu(), mask.cpu(), G, w.cpu(), out.cpu(), 1e-5,
            relu, sk is not None)
        for a, c in zip(got, want):
            if c is not None:
                _nonfinite_check(a, c, tol)


def _same_values(got, want):
    """NaN in the same places, every other element equal (-0.0 equals
    +0.0): the rule for kernels whose twin computes the same operations."""
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], want[~nan])


def _i8_inputs(case, C, device):
    import _kernel_edge_cases as E

    grid, scale, pts, c0, cell, off = E.i8_case(case, C)
    return [torch.from_numpy(a).to(device) for a in (grid, scale, pts, c0)] \
        + [cell, off]


@pytest.mark.cuda
@pytest.mark.parametrize("C", [4, 96, 128, 160])
@pytest.mark.parametrize("case", ["brick_faces", "grid_edges", "nonfinite",
                                  "one_cell", "no_points", "four_channels",
                                  "anchor_runs", "alternating", "ragged"])
def test_trilinear_i8_kernel_equals_twin_at_edges(case, C):
    """K6-int8 against its twin on the int8 edge inputs (the anchors at -1
    and dim - 1 and the pad's nodes, outside the grid, non-finite points,
    runs of one anchor, alternating anchors, a ragged tile), written into
    channels [4, 4 + C) of a wider output whose other channels stay
    untouched: equal, NaN for NaN. Both load widths the kernel takes (16
    int8 channels a lane where C % 16 == 0 and the grid starts on 16
    bytes, else 4: here C = 4 and a grid that starts 4 bytes into its
    storage) give the same bits, into channel offset 0 (16-byte stores
    where C allows) and 4 (8-byte ones); so do the queries in a shuffled
    order (the taps a lane keeps along a run of one anchor)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from tdvnet_torch.kernels.trilinear import (trilinear_sample_i8,
                                                trilinear_sample_i8_ref)

    grid, scale, pts, c0, cell, off = _i8_inputs(case, C, "cuda")
    B, Q = pts.shape[:2]
    out = torch.full((B, Q, C + 8), 7.0, dtype=torch.bfloat16, device="cuda")
    trilinear_sample_i8(grid, scale, pts, c0, cell, out, 4, cell_offset=off)
    want = trilinear_sample_i8_ref(grid.cpu(), scale.cpu(), pts.cpu(),
                                   c0.cpu(), cell, off)
    assert (out[..., :4] == 7).all() and (out[..., 4 + C:] == 7).all()
    got = out[..., 4:4 + C].cpu()
    _same_values(got, want)
    bits = lambda x: x.contiguous().view(torch.int16)
    store = torch.empty(grid.numel() + 4, dtype=torch.int8, device="cuda")
    shifted = store[4:].view(grid.shape)
    shifted.copy_(grid)
    assert shifted.data_ptr() % 16 == 4
    for g in (grid, shifted):
        for ch_off in (0, 4):
            o = torch.zeros((B, Q, C + 8), dtype=torch.bfloat16,
                            device="cuda")
            trilinear_sample_i8(g, scale, pts, c0, cell, o, ch_off,
                                cell_offset=off)
            assert torch.equal(bits(o[..., ch_off:ch_off + C].cpu()),
                               bits(got)), (g.data_ptr() % 16, ch_off)
    if Q:
        perm = _perm(Q, "cuda")
        o = torch.empty((B, Q, C), dtype=torch.bfloat16, device="cuda")
        trilinear_sample_i8(grid, scale, pts[:, perm].contiguous(), c0, cell,
                            o, 0, cell_offset=off)
        back = torch.empty_like(o)
        back[:, perm] = o
        assert torch.equal(bits(back.cpu()), bits(got))


def _pool_inputs(case, C, device):
    import _kernel_edge_cases as E

    y, seg, valid, n_seg = E.pool_case(case, C)
    return [torch.from_numpy(a).to(device) for a in (y, seg, valid)] \
        + [n_seg]


POOL_EDGE_CASES = ["specials", "all_invalid", "out_of_range", "one_long",
                   "trailing_empty", "long_threshold"]
PLAN_EDGE_CASES = ["no_points", "one_segment", "long_tiles", "many_points",
                   "sparse_scene"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", POOL_EDGE_CASES + PLAN_EDGE_CASES)
def test_segment_plan_kernel_matches_twin_at_edges(case):
    """The segment plan against its twin, on the pools' edge inputs and the
    plan's own (no points, one segment, long segments either side of the
    scan's tile boundaries, more points than the co-resident grid has
    threads, a scene's segments with few occupied): the same offsets, each
    segment's rows the same set (their order within a segment is the
    kernel's own), the same long segments (in any order), the same work
    partition, on two launches; the counts scratch zero again after each;
    at most one device kernel a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import _kernel_edge_cases as E
    import chip_smoke
    from tdvnet_torch.kernels import segmax
    from tdvnet_torch.kernels.segmax import SegmentPlan
    from tdvnet_torch.tools.time_pool_i8 import profile_calls

    if case in PLAN_EDGE_CASES:
        seg, valid, n_seg = (torch.from_numpy(a).cuda() if
                             isinstance(a, np.ndarray) else a
                             for a in E.plan_case(case))
    else:
        _, seg, valid, n_seg = _pool_inputs(case, 4, "cuda")
    want = segmax.segment_plan_ref(seg.cpu(), valid.cpu(), n_seg)
    for _ in range(2):
        got = segmax.segment_plan(seg, valid, n_seg)
        assert chip_smoke.plan_check(SegmentPlan(*(t.cpu() for t in got)),
                                     want)[1]
        torch.cuda.synchronize()
        for n, *_, scratch in segmax._PLAN_SCRATCH.values():
            assert not scratch[:n].any()
    # the profiler may drop a kernel of a short trace, never add one
    calls = profile_calls(lambda: segmax.segment_plan(seg, valid, n_seg))
    assert 0 < sum(k for name, (_, k) in calls.items()
                   if "segment_plan" in name) <= 1 + 1e-9


@pytest.mark.cuda
@pytest.mark.parametrize("C", [4, 128, 160])
@pytest.mark.parametrize("case", POOL_EDGE_CASES)
def test_pool_kernels_equal_twins_at_edges(case, C):
    """K4's pool and concat-back against their twins on the pools' edge
    inputs: equal, NaN for NaN, with the plan given and built by the pool;
    the pool the same bits on a second launch (its plan rebuilt, the rows
    placed in another order) and with the rows shuffled."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from tdvnet_torch.kernels import segmax

    y, seg, valid, n_seg = _pool_inputs(case, C, "cuda")
    want = segmax.segment_max_ref(y.cpu(), seg.cpu(), valid.cpu(), n_seg)
    plan = segmax.segment_plan(seg, valid, n_seg)
    got = segmax.segment_max(y, seg, valid, n_seg, plan)
    _same_values(got.cpu(), want)
    assert _same_bits(got, segmax.segment_max(y, seg, valid, n_seg))
    i = _perm(len(seg), "cuda")
    assert _same_bits(got, segmax.segment_max(y[i], seg[i], valid[i], n_seg))
    for relu in (False, True):
        _same_values(segmax.gather_concat(y, got, seg, relu).cpu(),
                     segmax.gather_concat_ref(y.cpu(), want, seg.cpu(),
                                              relu))


# ------------------------------- the soft-argmax (K8b) and K8a's backward
def _softargmax_inputs(case, device):
    import _kernel_edge_cases as E

    return [torch.from_numpy(a).to(device) for a in E.softargmax_case(case)]


SOFTARGMAX_EDGE_CASES = ["one_plane", "ragged_band", "infinities", "nan",
                         "ties", "large", "twelve_planes", "zero_grad",
                         "many_planes", "most_planes"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SOFTARGMAX_EDGE_CASES)
def test_softargmax_kernel_matches_twin_at_edges(case):
    """K8b against its twin on `tests/_kernel_edge_cases.py`'s edges (one
    plane, a ragged last band of planes, +-inf costs, NaN, exact ties,
    costs x100; every map's last strip of pixels cut): NaN and inf
    where the twin has them, the rest within 1e-5, and the same bits on a
    second launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from tdvnet_torch.kernels import softargmax_depth
    from tdvnet_torch.kernels.softargmax import softargmax_depth_ref

    cost, dv, _ = _softargmax_inputs(case, "cuda")
    _leave_nan(cost.shape[:1] + cost.shape[2:], "cuda")
    got = softargmax_depth(cost, dv)
    torch.cuda.synchronize()
    _nonfinite_check(got, softargmax_depth_ref(cost, dv), 1e-5)
    assert _same_bits(got, softargmax_depth(cost, dv))
    if case in ("infinities", "nan"):
        assert torch.isnan(got).any() and torch.isfinite(got).any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", SOFTARGMAX_EDGE_CASES)
def test_softargmax_backward_kernel_matches_twin_at_edges(case):
    """K8b's backward against its twin on the soft-argmax edges (1, 12, 13,
    24 and 97 planes, odd maps, +-inf and NaN costs, ties, costs x100,
    incoming gradients of 0 and -0.0), the depths the twin's: NaN and inf
    where the twin has them, the rest within 1e-5 of the largest gradient;
    the same bits on a second launch; at most one device kernel a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from tdvnet_torch.kernels import softargmax_depth_backward
    from tdvnet_torch.kernels.softargmax import (
        softargmax_depth_backward_ref, softargmax_depth_ref)
    from tdvnet_torch.tools.time_pool_i8 import profile_calls

    cost, dv, grad = _softargmax_inputs(case, "cuda")
    depth = softargmax_depth_ref(cost, dv)
    _leave_nan(cost.shape, "cuda")
    got = softargmax_depth_backward(grad, cost, dv, depth)
    torch.cuda.synchronize()
    _nonfinite_check(got, softargmax_depth_backward_ref(grad, cost, dv,
                                                        depth), 1e-5)
    assert _same_bits(got, softargmax_depth_backward(grad, cost, dv, depth))
    if case == "zero_grad":
        assert not got[0].any()
    # the profiler may drop a kernel of a short trace, never add one
    calls = profile_calls(lambda: softargmax_depth_backward(grad, cost, dv,
                                                            depth))
    assert 0 < sum(k for name, (_, k) in calls.items()
                   if "softargmax_depth_backward" in name) <= 1 + 1e-9


@pytest.mark.cuda
def test_softargmax_kernel_raises_past_its_registers():
    """Past the planes a block's warps hold in registers the wrappers take
    the any-D form, forward and backward, where they once raised; the
    largest count that fits runs the register form (32 warps, shared
    memory past the default 48 KB). Both within 1e-5 of the twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from tdvnet_torch.kernels import softargmax
    from tdvnet_torch.kernels.softargmax import softargmax_depth_ref

    g = torch.Generator().manual_seed(2)
    for D in (softargmax.max_planes(), softargmax.max_planes() + 1):
        cost = (torch.randn(2, D, 3, 5, generator=g) * 3).cuda()
        dv = torch.linspace(0.5, 3.0, D).cuda()
        got = softargmax.softargmax_depth(cost, dv)
        _nonfinite_check(got, softargmax_depth_ref(cost, dv), 1e-5)
        gr = torch.randn(2, 3, 5, generator=g).cuda()
        _nonfinite_check(
            softargmax.softargmax_depth_backward(gr, cost, dv, got),
            softargmax.softargmax_depth_backward_ref(gr, cost, dv, got),
            1e-5)


def _planes_inputs(D, device="cuda", seed=0):
    """A regularised cost volume's shape at the batch's size, [14, D, 56,
    56] with D planes: seeded costs x3 (`chip_smoke.kernel_cases`' scale),
    the plane depths of a D-plane sweep from 0.5 m, incoming gradients."""
    g = torch.Generator().manual_seed(seed)
    cost = (torch.randn(14, D, 56, 56, generator=g) * 3).to(device)
    dv = (0.5 + 0.05 * torch.arange(D, dtype=torch.float32)).to(device)
    grad = torch.randn(14, 56, 56, generator=g).to(device)
    return cost, dv, grad


@pytest.mark.cuda
@pytest.mark.parametrize("D", [392, 768])
def test_softargmax_kernels_take_any_plane_count(D):
    """K8b's forward and backward past the register form's 384 planes, at
    the batch's [14, D, 56, 56]: within 1e-5 of the fp32 twin and of a
    float64 referee (the twin over float64 costs, rounded), launched once
    each, the same bits on a second launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from tdvnet_torch.kernels import softargmax as S

    cost, dv, grad = _planes_inputs(D)
    before = (S.softargmax_depth.launches,
              S.softargmax_depth_backward.launches)
    with torch.no_grad():
        depth = S.softargmax_depth(cost, dv)
    gc = S.softargmax_depth_backward(grad, cost, dv, depth)
    torch.cuda.synchronize()
    assert (S.softargmax_depth.launches - before[0],
            S.softargmax_depth_backward.launches - before[1]) == (1, 1)
    _nonfinite_check(depth, S.softargmax_depth_ref(cost, dv), 1e-5)
    _nonfinite_check(depth, S.softargmax_depth_ref(
        cost.double(), dv.double()).float(), 1e-5)
    tol = 1e-5 * float(grad.abs().max() * dv.abs().max())
    _nonfinite_check(gc, S.softargmax_depth_backward_ref(grad, cost, dv,
                                                         depth), tol)
    _nonfinite_check(gc, S.softargmax_depth_backward_ref(
        grad.double(), cost.double(), dv.double(), depth.double()).float(),
        tol)
    with torch.no_grad():
        assert _same_bits(depth, S.softargmax_depth(cost, dv))
    assert _same_bits(gc, S.softargmax_depth_backward(grad, cost, dv, depth))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [96, 384])
def test_softargmax_any_plane_form_equals_the_register_form(D):
    """The any-D form, launched where the register form runs (D = 96, the
    main path's, and 384, its largest), gives the register form's bits,
    forward and backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from tdvnet_torch.kernels import softargmax as S

    cost, dv, grad = _planes_inputs(D, seed=1)
    depth = S._softargmax_depth(cost, dv)
    assert _same_bits(depth, S._softargmax_depth(cost, dv, long_form=True))
    assert _same_bits(
        S._softargmax_depth_backward(grad, cost, dv, depth),
        S._softargmax_depth_backward(grad, cost, dv, depth, long_form=True))


# ------------------------------- channel counts that are not a multiple of 4
ODD_WIDTHS = [6, 10, 30]


@pytest.mark.cuda
@pytest.mark.parametrize("C", ODD_WIDTHS)
def test_source_variance_kernels_take_any_channel_count(C):
    """K1 (variance and mean) and its backward at a channel count that is
    not a multiple of 4 (the wrappers pad to whole 4-channel groups): the
    twins' values within the multiple-of-4 tests' tolerances, NaN for NaN,
    one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import _kernel_edge_cases as E
    import chip_smoke
    from tdvnet_torch.kernels import variance as K

    args = _variance_inputs(E.variance_case("nonfinite", C), "cuda")
    cpu = [a.cpu() if torch.is_tensor(a) else a for a in args]
    before = (K.source_variance.launches,
              K.source_variance_backward.launches)
    var, mean = K._source_variance(*args, True)
    for g, w in zip((var, mean), K.source_variance_ref(*cpu,
                                                       with_mean=True)):
        _variance_check(g.cpu(), w, 1e-4)
    R, P = args[0].shape[:2]
    grad = torch.randn(R, P, C, generator=torch.Generator().manual_seed(
        1)).cuda()
    got = K.source_variance_backward(grad, mean, *args[:5], args[5], (1, P))
    _variance_check(got.cpu(), K.source_variance_backward_ref(
        grad.cpu(), mean.cpu(), *cpu), chip_smoke.VARIANCE_BACKWARD_TOL)
    assert (K.source_variance.launches - before[0],
            K.source_variance_backward.launches - before[1]) == (1, 1)
    assert var.is_contiguous() and got.shape == args[1].shape


@pytest.mark.cuda
@pytest.mark.parametrize("C", ODD_WIDTHS)
def test_trilinear_kernels_take_any_channel_count(C):
    """K6 into a slice at an odd offset of a wider output (one channel a
    lane; the other channels untouched), K6's grid backward and K6-int8
    into a slice (their wrappers pad to whole 4-channel groups), at a
    channel count that is not a multiple of 4: the twins' values within the
    multiple-of-4 tests' tolerances, one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import _kernel_edge_cases as E
    from tdvnet_torch.kernels import trilinear as T

    grid, pts, c0, cell = _tri_forward("grid_edges", C, "cuda")
    B, Q = pts.shape[:2]
    n0 = (T.trilinear_sample.launches, T.trilinear_sample_backward.launches,
          T.trilinear_sample_i8.launches)
    out = torch.full((B, Q, C + 7), 7.0, device="cuda")
    T.trilinear_sample(grid, pts, c0, cell, out, 3)
    want = T.trilinear_sample_ref(grid.cpu(), pts.cpu(), c0.cpu(), cell)
    assert (out[..., :3] == 7).all() and (out[..., 3 + C:] == 7).all()
    _variance_check(out[..., 3:3 + C].cpu(), want, 1e-5)
    fin = torch.isfinite(pts).all(-1)
    g = torch.randn(B, Q, C, generator=torch.Generator().manual_seed(
        C)).cuda() * fin[..., None]
    _tri_check(T.trilinear_sample_backward(g, pts, c0, cell,
                                           tuple(grid.shape)).cpu(),
               _tri_referee(g.cpu(), pts.cpu(), c0.cpu(), cell,
                            tuple(grid.shape)))
    gi, sc, pi, ci, celli, off = (torch.from_numpy(a).cuda()
                                  if isinstance(a, np.ndarray) else a
                                  for a in E.i8_case("grid_edges", C))
    o8 = torch.full((B, pi.shape[1], C + 5), 7.0, dtype=torch.bfloat16,
                    device="cuda")
    T.trilinear_sample_i8(gi, sc, pi, ci, celli, o8, 5, off)
    assert (o8[..., :5] == 7).all()
    _same_values(o8[..., 5:].cpu(), T.trilinear_sample_i8_ref(
        gi.cpu(), sc.cpu(), pi.cpu(), ci.cpu(), celli, off))
    assert (T.trilinear_sample.launches - n0[0],
            T.trilinear_sample_backward.launches - n0[1],
            T.trilinear_sample_i8.launches - n0[2]) == (1, 1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [8, 64])
def test_trilinear_one_channel_form_equals_the_four_channel_form(C):
    """K6's one-channel-a-lane form does each channel's operations of the
    4-channel form: into an output one channel wider (offset 1) it gives
    the bits of the exact-width call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from tdvnet_torch.kernels.trilinear import trilinear_sample

    grid, pts, c0, cell = _tri_forward("alternating", C, "cuda")
    B, Q = pts.shape[:2]
    quad = trilinear_sample(grid, pts, c0, cell,
                            torch.empty(B, Q, C, device="cuda"), 0)
    one = trilinear_sample(grid, pts, c0, cell,
                           torch.empty(B, Q, C + 1, device="cuda"), 1)
    assert _same_bits(one[..., 1:], quad)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [2, 10])
def test_scatter_kernels_take_any_channel_count(C):
    """K3's dense scatter and its backward at the PointNet's 2 * feat_dim
    channels for an odd feat_dim: the twins' bits (a copy either way)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    _scatter_check("three_scenes", False, C)


def _odd_width_setup():
    import copy

    from tdvnet_torch.config import _overlay, tiny_test_config
    from tdvnet_torch.data import batch as B, synthetic
    from tdvnet_torch.models.threedvnet import ThreeDVNet

    cfg = _overlay(tiny_test_config(), {"model": {
        "feat_dim": 5, "unet_dims": (10, 18, 30), "unet_groups": (2, 3, 3)}})
    bc = cfg.batch
    batch = B.collate_scenes(
        [synthetic.make_batch_scene(bc.n_views, bc.img_size,
                                    bc.depth_img_size, seed=0)],
        bc.n_views, bc.n_ref, bc.n_src_on_either_side)
    torch.manual_seed(0)
    cpu = ThreeDVNet(cfg.model)
    return cfg, batch, cpu, copy.deepcopy(cpu).cuda()


@pytest.mark.cuda
def test_odd_width_model_runs_on_the_card():
    """The odd-width tiny config (feat_dim 5, U-Net widths 10, 18, 30):
    `infer_depth` on the card against the CPU's (the limits of
    tests/test_torch_infer.py), then one n_iters=1 train step on the card
    against its float64 rerun through the twins (the limits of
    `test_refinement_train_step_on_the_card_matches_the_cpu`), every kernel
    of the path launched as at multiple-of-4 widths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import dataclasses

    import chip_smoke
    from tdvnet_torch.kernels import launch_counts, reset_launch_counts
    from tdvnet_torch.train import loop as L

    cfg, batch, f64, card = _odd_width_setup()
    offsets = ((0.05, 0.025), (0.025,))
    with torch.no_grad():
        d = (card.eval().infer_depth(batch, offsets).cpu()
             - f64.eval().infer_depth(batch, offsets)).abs().numpy()
    assert np.median(d) < 1e-5 and np.percentile(d, 99) < 1e-4, \
        (np.median(d), np.percentile(d, 99))
    card.train()
    st = L.TrainState(card, L.make_optimizer(cfg, card, 1))
    reset_launch_counts()
    _, mets = L.make_train_step(card, cfg, 1)(st, batch, 0.5)
    counts = launch_counts()
    f64 = f64.double().train()
    b64 = dataclasses.replace(batch, images=batch.images.double(),
                              depth_gt=batch.depth_gt.double())
    with torch.backends.mkldnn.flags(enabled=False), \
            chip_smoke.float64_twins():
        out = f64(b64, list(cfg.train.offsets), 1, 0.5,
                  with_metrics=False, backbone_train=False)
        out["loss"].backward()
    want = float(out["loss"])
    assert abs(float(mets["loss"]) - want) <= 1e-5 * abs(want)
    assert counts == chip_smoke.train_expected_launches(
        1, 1, len(cfg.train.offsets), cfg.model.unet_res)
    # the PointNet's max pools route a few maxima to other rows than in
    # float64: its leaves take phase 9b's referee limits for them
    # (chip_smoke.REFEREE_REFINE_GRAD_REL); fc_pos read 1.8e-3 here
    pool = chip_smoke.REFEREE_REFINE_GRAD_REL
    loose = ("refine_", "mvsnet.fpn.lateral0.", "mvsnet.fpn.smooth0.")

    def limit(k):
        if k in pool:
            return pool[k]
        if k.startswith("pointnet."):
            return pool["pointnet"]
        return 1e-2 if k.startswith(loose) else 1e-3

    bad = {}
    for k, p in f64.named_parameters():
        g = card.get_parameter(k).grad
        if g is None or p.grad is None or k in chip_smoke.ZERO_GRADS:
            continue
        g = g.double().cpu()
        e = float((g - p.grad).norm() / p.grad.norm().clamp(min=1e-12))
        if e > limit(k):
            bad[k] = e
    assert not bad, sorted(bad.items(), key=lambda kv: -kv[1])[:10]


def _blend_inputs(case, device):
    import _kernel_edge_cases as E
    from tdvnet_torch.kernels.propagation import propagation_blend_ref

    grad, logits, depth = (torch.from_numpy(a).to(device)
                           for a in E.blend_case(case))
    view = logits.permute(0, 2, 3, 1)
    return grad, view, depth, propagation_blend_ref(view, depth)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_pixel", "one_row", "one_column",
                                  "two_by_two", "ragged"])
def test_blend_backward_kernel_matches_twin_at_edges(case):
    """K8a's one-launch backward against its twin on the edge maps (one
    pixel, one row, one column, 2 x 2, where several taps clamp onto one
    source pixel; 33 x 65, cut by the 32 x 8 tiles on both axes): both
    gradients within 1e-5, the logits' gradient in the permuted layout of
    the logits, the same bits on a second launch, and an incoming gradient
    with a NaN and both infinities gives the twin's non-finite pattern."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import chip_smoke
    from tdvnet_torch.kernels import propagation_blend_backward
    from tdvnet_torch.kernels.propagation import propagation_blend_backward_ref

    grad, view, depth, out = _blend_inputs(case, "cuda")
    _leave_nan(depth.shape, "cuda")
    got = propagation_blend_backward(grad, view, depth, out)
    torch.cuda.synchronize()
    assert got[0].stride() == view.stride()
    for a, b in zip(got, propagation_blend_backward_ref(grad, view, depth,
                                                        out)):
        _nonfinite_check(a, b, chip_smoke.BACKWARD_TOL)
    again = propagation_blend_backward(grad, view, depth, out)
    assert all(_same_bits(a, b) for a, b in zip(got, again))
    bad = _poison(grad, 6)
    for a, b in zip(propagation_blend_backward(bad, view, depth, out),
                    propagation_blend_backward_ref(bad, view, depth, out)):
        _nonfinite_check(a, b, chip_smoke.BACKWARD_TOL)


# ----------------------------------------------------------- bf16 inference
BF16_KERNELS = ("source_variance_bf16", "trilinear_sample_bf16",
                "voxelize_bf16", "segment_max_bf16",
                "masked_group_norm_bf16")


@pytest.fixture(scope="module")
def bf16_cases():
    """`chip_smoke.bf16_cases`: each bf16 form on the inputs of one bf16
    `infer_depth` of the golden batch (synth48 weights), with its twin and
    its float64 referee."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import chip_smoke
    from tdvnet_torch.config import ModelConfig
    from tdvnet_torch.weights import load_threedvnet

    model = load_threedvnet(chip_smoke.WEIGHTS,
                            ModelConfig(dtype=torch.bfloat16), device="cuda")
    return chip_smoke.bf16_cases(model, torch.device("cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", BF16_KERNELS)
def test_bf16_form_matches_twin_and_referee_on_the_main_path(kernel,
                                                             bf16_cases):
    import chip_smoke

    cases = [c for c in bf16_cases if c.kernel == kernel]
    assert cases
    for case in cases:
        err, ok = chip_smoke.check_case(case)
        assert ok, f"{kernel} {case.label}: max |d| {err:.3e}"


@pytest.mark.cuda
def test_bf16_forms_count_apart_and_take_odd_shapes():
    """Each bf16 form counts in its wrapper's `bf16_launches` only, and
    matches its twin where the kernel takes its one-channel or unvectorised
    form (K6 at C = 5, K5 at V % 4 != 0) or the wrapper pads (K1 at C =
    6): K6 within one bf16 ulp, K5 within one ulp of its ops' scale, K1
    within `chip_smoke.BF16_VAR_TWIN_REL` E[F^2] (and one rounding of a
    bf16 variance)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import chip_smoke
    from tdvnet_torch import kernels as K
    from tdvnet_torch.kernels.groupnorm import masked_group_norm_ref
    from tdvnet_torch.kernels.trilinear import trilinear_sample_ref
    from tdvnet_torch.kernels.variance import source_variance_ref
    from tdvnet_torch.tools.timing import bf16_ulp

    g = torch.Generator().manual_seed(5)
    dev, bf = "cuda", torch.bfloat16
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev)
    K.reset_launch_counts()
    grid = rnd(2, 7, 6, 5, 5).to(bf)
    pts = (torch.rand(2, 300, 3, generator=g) * 8 - 1).to(dev)
    c0 = torch.zeros(2, 3, device=dev)
    out = torch.empty(2, 300, 9, dtype=bf, device=dev)
    got = K.trilinear_sample(grid, pts, c0, 1.0, out, 3)[..., 3:8]
    want = trilinear_sample_ref(grid, pts, c0, 1.0)
    scale = torch.maximum(got.double().abs(), want.double().abs())
    assert bool(((got.double() - want.double()).abs()
                 <= bf16_ulp(scale)).all())
    mask = (torch.rand(2, 1, 5, 3, 3, generator=g) > 0.3).to(dev).to(bf)
    x = (rnd(2, 8, 5, 3, 3) * mask).to(bf)
    skip = (rnd(2, 8, 5, 3, 3) * mask).to(bf)
    w, b = rnd(8), rnd(8)
    for kw in ({"relu": True}, {"skip": skip}):
        y = K.masked_group_norm(x, mask, 2, w, b, **kw)
        ref, scale = chip_smoke.gn_bf16_referee(x, mask, 2, w, b,
                                                kw.get("relu", False),
                                                kw.get("skip"))
        assert y.dtype == bf
        assert float(chip_smoke.bf16_ulps(y, ref, scale).max()) <= 1.0
        assert float(chip_smoke.bf16_ulps(
            y, masked_group_norm_ref(x, mask, 2, w, b, **kw),
            scale).max()) <= 1.0
    feats = (rnd(4, 9, 11, 6) + 0.5).to(bf)
    cam = torch.tensor([[20., 0, 5, 0], [0, 20., 4, 0], [0, 0, 1, 0]])
    P_all = cam.expand(4, 3, 4).contiguous().to(dev)
    pts3 = torch.cat([torch.rand(2, 50, 2, generator=g) - 0.5,
                      torch.full((2, 50, 1), 2.0)], -1).to(dev)
    sidx = torch.tensor([[1, 2], [2, 3]], device=dev)
    smask = torch.ones(2, 2, dtype=torch.bool, device=dev)
    args = (pts3, feats, sidx, smask, P_all, (36, 44))
    for od in (torch.float32, bf):
        v = K.source_variance(*args, (1, 50), out_dtype=od)
        vr = source_variance_ref(*args, out_dtype=od)
        va, ma = source_variance_ref(pts3, feats.double().abs(), *args[2:],
                                     with_mean=True)
        ef2 = (va + ma ** 2).clamp(min=1e-30)
        assert v.dtype == od
        assert float(((v.double() - vr.double()).abs() / ef2).max()) \
            <= chip_smoke.BF16_VAR_TWIN_REL + 2.0 ** -8
    torch.cuda.synchronize()
    assert K.bf16_launch_counts() == {
        "source_variance_bf16": 2, "trilinear_sample_bf16": 1,
        "scatter_anchors_to_dense_bf16": 0, "segment_max_bf16": 0,
        "gather_concat_bf16": 0, "masked_group_norm_bf16": 2,
        **{k: 0 for k in K.BF16_FORMS if k.endswith("_backward_bf16")}}
    assert all(n == 0 for n in K.launch_counts().values())
    with pytest.raises(TypeError):
        K.trilinear_sample(grid.half(), pts, c0, 1.0,
                           torch.empty(2, 300, 5, dtype=torch.half,
                                       device=dev), 0)


# ------------------------------------------------- the bf16 backward forms
# Each bf16 backward form (a bf16 model in training) against its plain twin
# (the fp32 backward on the widened inputs, rounded once to bf16) and its
# float64 referee, by `chip_smoke.bf16_grad_check`'s rules: K3 and K4's
# pool bit-equal, the sums within one bf16 ulp plus their fixed-point
# floor (K1/K2 also the allowance for samples that round to the
# neighbouring bf16 value); then the same
# bits on a second launch and with the points (rows) shuffled. C = 32 is
# the cost volume's width, 30 and 62 take the padded 4-channel groups.
BF16_BACKWARD_WIDTHS = (32, 30, 62)


def _bf16_check(got, twin, ref, terms=None, exact=False, extra=None):
    import chip_smoke

    twin, ref = twin.to(got.device), ref.to(got.device)
    if terms is not None:
        terms = terms.to(got.device)
    if extra is not None:
        extra = extra.to(got.device)
    m_twin, m_ref, ok = chip_smoke.bf16_grad_check(got, twin, ref, terms,
                                                   exact, extra)
    print(f"  vs twin {m_twin:.3f}, vs float64 referee {m_ref:.3f} "
          f"(limit 1)")
    assert ok, (m_twin, m_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("C", BF16_BACKWARD_WIDTHS)
@pytest.mark.parametrize("grad_bf16", [True, False])
def test_source_variance_backward_bf16_form(C, grad_bf16):
    """K1/K2's bf16 backward (bf16 features, a bf16 or fp32 grad) against
    its twin and its float64 referee, the same bits on a second launch, as
    planes and with the points shuffled."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import chip_smoke
    from tdvnet_torch.kernels import variance as K

    bf = torch.bfloat16
    pts, feats, sidx, smask, P_all, grad = _variance_args(
        "cuda", R=3, P=4096, N=5, Hf=28, Wf=36, C=C, seed=C)
    feats = feats.to(bf)
    img = (112, 144)
    od = bf if grad_bf16 else torch.float32
    _, mean = K._source_variance(pts, feats, sidx, smask, P_all, img, True,
                                 od)
    grad = grad.to(od)
    rest = (sidx, smask, P_all, img)
    K.source_variance_backward.bf16_launches = 0
    got = K.source_variance_backward(grad, mean, pts, feats, *rest, (1, 4096))
    assert got.dtype == bf and K.source_variance_backward.bf16_launches == 1
    cpu = [x.cpu() for x in (grad, mean, pts, feats, sidx, smask, P_all)]
    twin = K.source_variance_backward_ref(*cpu, img)
    ref, extra = chip_smoke.variance_backward_bf16_referee(*cpu, img)
    _bf16_check(got, twin, ref, extra=extra)
    assert _same_bits(got, K.source_variance_backward(
        grad, mean, pts, feats, *rest, (1, 4096)))
    assert _same_bits(got, K.source_variance_backward(
        grad, mean, pts, feats, *rest, (16, 64)))
    i = _perm(4096, "cuda")
    assert _same_bits(got, K.source_variance_backward(
        grad[:, i].contiguous(), mean[:, i].contiguous(),
        pts[:, i].contiguous(), feats, *rest, (1, 4096)))


@pytest.mark.cuda
@pytest.mark.parametrize("C", BF16_BACKWARD_WIDTHS)
def test_trilinear_backward_bf16_form(C):
    """K6's bf16 grid backward against its twin and its float64 referee,
    crowded into bricks of several chunks, the same bits on a second launch
    and with the points shuffled."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import chip_smoke
    from tdvnet_torch.kernels import trilinear as T

    bf = torch.bfloat16
    dev = torch.device("cuda")
    B, Q, dims, cell = 2, 30000, (16, 12, 20), 1.0
    g = torch.Generator().manual_seed(C)
    pts = (torch.rand(B, Q, 3, generator=g)
           * (torch.tensor(dims) + 1.0) - 1.0).to(dev)
    c0 = torch.zeros(B, 3, device=dev)
    grad = torch.randn(B, Q, C, generator=g).to(bf).to(dev)
    shape = (B, *dims, C)
    T.trilinear_sample_backward.bf16_launches = 0
    got = T.trilinear_sample_backward(grad, pts, c0, cell, shape)
    assert got.dtype == bf and T.trilinear_sample_backward.bf16_launches == 1
    twin = T.trilinear_sample_backward_ref(grad.cpu(), pts.cpu(), c0.cpu(),
                                           cell, shape)
    ref = T.trilinear_sample_backward_ref(grad.double(), pts, c0, cell,
                                          shape)
    terms = T.trilinear_sample_backward_ref(grad.double().abs(), pts, c0,
                                            cell, shape)
    _bf16_check(got, twin, ref, terms,
                extra=chip_smoke.trilinear_backward_fixed_allowance(
                    grad, pts, c0, cell, shape))
    assert _same_bits(got, T.trilinear_sample_backward(grad, pts, c0, cell,
                                                       shape))
    i = _perm(Q, dev)
    assert _same_bits(got, T.trilinear_sample_backward(
        grad[:, i].contiguous(), pts[:, i].contiguous(), c0, cell, shape))


@pytest.mark.cuda
@pytest.mark.parametrize("C", BF16_BACKWARD_WIDTHS)
def test_masked_group_norm_backward_bf16_form(C):
    """K5's bf16 backward in its three tails against its twin and its
    float64 referee (d x, d skip; d weight and d bias as bf16 values in
    fp32), the same bits on a second launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import chip_smoke
    from tdvnet_torch.kernels import groupnorm as K

    bf = torch.bfloat16
    G = 2
    g = torch.Generator().manual_seed(C)
    dims = (12, 10, 16)
    mask = (torch.rand(2, 1, *dims, generator=g) > 0.4).float()
    x = ((torch.randn(2, C, *dims, generator=g) + 0.3) * mask).to(bf).cuda()
    skip = (torch.randn(2, C, *dims, generator=g) * mask).to(bf).cuda()
    grad = torch.randn(2, C, *dims, generator=g).to(bf).cuda()
    w = (torch.rand(C, generator=g) + 0.5).cuda()
    b = (torch.randn(C, generator=g) * 0.1).cuda()
    mask = mask.to(bf).cuda()
    for relu, sk in ((False, None), (True, None), (False, skip)):
        out, stats = K._masked_group_norm(x, mask, G, w, b, 1e-5, relu, sk)
        args = (x, mask, G, w, out, stats, 1e-5, relu, sk is not None)
        got = K.masked_group_norm_backward(grad, *args, bias=b)
        cpu = [t.cpu() for t in (grad, x, mask)]
        twin = K.masked_group_norm_backward_ref(
            *cpu, G, w.cpu(), out.cpu(), 1e-5, relu, sk is not None)
        ref, terms = chip_smoke.gn_backward_bf16_referee(
            *cpu, G, w.cpu(), out.cpu(), relu, sk is not None)
        for a, t_, r, tm in zip(got, twin, ref, terms):
            if a is None:
                assert t_ is None
                continue
            _bf16_check(a, t_, r, tm, exact=tm is None)
        again = K.masked_group_norm_backward(grad, *args, bias=b)
        for a, c in zip(got, again):
            if a is not None:
                assert _same_bits(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("C", BF16_BACKWARD_WIDTHS)
def test_pool_and_concat_backward_bf16_forms(C):
    """K4's pool backward (bit-equal to its twin and referee) and
    concat-back (within one bf16 ulp) in bf16, and the same bits on a
    second launch and with the rows shuffled."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import chip_smoke
    from tdvnet_torch.kernels import segmax as K

    if C % 4:
        pytest.skip("the PointNet's widths are multiples of 4 (4 f, 8 f)")
    bf = torch.bfloat16
    P, n_seg = 20000, 3000
    grad2, y, _, seg = _concat_case(P, C, n_seg, C, "cuda")
    # coarse values, so that rows tie for a segment's maximum
    y = (y * 4).round().div(4).to(bf)
    valid = torch.rand(P, generator=torch.Generator().manual_seed(1)) > 0.1
    valid = valid.cuda()
    pooled = K.segment_max(y, seg, valid, n_seg)
    gpool = torch.randn(n_seg, C, generator=torch.Generator().manual_seed(
        2)).to(bf).cuda()
    got = K.segment_max_backward(gpool, y, seg, valid, pooled)
    cpu = [t.cpu() for t in (gpool, y, seg, valid, pooled)]
    twin = K.segment_max_backward_ref(*cpu)
    ref = K.segment_max_backward_ref(cpu[0].double(), cpu[1].double(),
                                     cpu[2], cpu[3], cpu[4].double())
    _bf16_check(got, twin, ref, exact=True)
    i = _perm(P, "cuda")
    assert _same_bits(got[i], K.segment_max_backward(
        gpool, y[i], seg[i], valid[i], pooled))
    grad2 = grad2.to(bf)
    for relu in (False, True):
        gy, gp = K.gather_concat_backward(grad2, y, pooled, seg, relu)
        cpu = [t.cpu() for t in (grad2, y, pooled, seg)]
        ty, tp = K.gather_concat_backward_ref(*cpu, relu)
        d = [t.double() if t.is_floating_point() else t for t in cpu]
        ry, rp = K.gather_concat_backward_ref(*d, relu)
        terms = K.gather_concat_backward_ref(d[0].abs(), *d[1:], relu)[1]
        _bf16_check(gy, ty, ry, exact=True)
        _bf16_check(gp, tp, rp, terms,
                    extra=chip_smoke.concat_backward_fixed_allowance(
                        grad2, seg, n_seg))
        gy2, gp2 = K.gather_concat_backward(grad2, y, pooled, seg, relu)
        assert _same_bits(gy, gy2) and _same_bits(gp, gp2)
        gy3, gp3 = K.gather_concat_backward(grad2[i], y[i], pooled, seg[i],
                                            relu)
        assert _same_bits(gp, gp3) and _same_bits(gy[i], gy3)


@pytest.mark.cuda
@pytest.mark.parametrize("C", BF16_BACKWARD_WIDTHS)
def test_scatter_backward_bf16_form(C):
    """K3's bf16 backward (a gather of the grid's gradient) bit-equal to
    its twin and its float64 referee, as they are and shuffled."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import _kernel_edge_cases as E
    from tdvnet_torch.kernels import voxelize as vox

    bf = torch.bfloat16
    _, idx3, scene, valid, grid, B = E.scatter_case("all_valid")
    for shuffled in (False, True):
        if shuffled:
            perm = np.random.default_rng(1).permutation(len(valid))
            idx3, scene, valid = (x[perm] for x in (idx3, scene, valid))
        vg = vox._anchor_table(*(torch.from_numpy(np.ascontiguousarray(x))
                                 .cuda() for x in (idx3, scene, valid)))
        g = torch.randn(B, *grid, C, generator=torch.Generator().manual_seed(
            C)).to(bf).cuda()
        got = vox.scatter_anchors_to_dense_backward(g, vg, grid, B)
        twin = vox.scatter_anchors_to_dense_backward_ref(g, vg, grid, B)
        ref = vox.scatter_anchors_to_dense_backward_ref(g.double(), vg, grid,
                                                        B)
        _bf16_check(got, twin, ref, exact=True)
