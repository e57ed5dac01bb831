"""The port's CUDA kernels against their plain twins, on the card, at the
shapes the full-width main path gives them (the cases of `chip_smoke.py`).

These tests need an NVIDIA card and `nvcc`; without a card they skip. The
card's machine has no JAX, so run them there without the repo's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import pytest
import torch

KERNELS = ("source_variance", "trilinear_sample", "propagation_blend",
           "softargmax_depth")


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
