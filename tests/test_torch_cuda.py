"""The port's CUDA kernels against their plain twins, on the card, at the
shapes the full-width main path gives them (the cases of `chip_smoke.py`).

These tests need an NVIDIA card and `nvcc`; without a card they skip. The
card's machine has no JAX, so run them there without the repo's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import pytest
import torch

KERNELS = ("source_variance", "trilinear_sample", "propagation_blend",
           "softargmax_depth", "voxelize", "segment_max", "masked_group_norm")


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
