"""The host side of the K8 timing tool (`tdvnet_torch.tools.time_depthops`)
on the CPU, against plain numpy: the byte and flop counts and the bounds of
`chip_smoke.py`, the digests, and the edge inputs the tool hands to both
trees. The timing itself needs the card."""
import hashlib

import numpy as np
import pytest
import torch

import _kernel_edge_cases as E
from _torch_helpers import torch_one_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("case", [c[0] for c in E.SOFTARGMAX_CASES])
def test_softargmax_counts_and_bound(case):
    import chip_smoke
    from tdvnet_torch.tools import time_depthops as T

    cost, dv, _ = E.softargmax_case(case)
    R, D, h, w = cost.shape
    nbytes, flops = T.softargmax_cost(torch.from_numpy(cost))
    # the volume and the plane depths read once, the depths written once
    assert nbytes == 4 * (cost.size + dv.size + R * h * w)
    assert flops == 5 * cost.size
    ref = chip_smoke.Case("softargmax_depth", "", 1, None, None, 1e-5,
                          nbytes, flops)
    assert T.bound_ms(nbytes, flops) == pytest.approx(ref.bound_ms,
                                                      rel=1e-12)
    assert T.bound_ms(nbytes, flops) == pytest.approx(
        1e3 * max(nbytes / 3.35e12, flops / 67e12), rel=1e-12)


@pytest.mark.parametrize("case", [c[0] for c in E.BLEND_CASES])
def test_blend_backward_counts_and_bound(case):
    import chip_smoke
    from tdvnet_torch.tools import time_depthops as T

    _, logits, depth = E.blend_case(case)
    N, H, W = depth.shape
    nbytes, flops = T.blend_backward_cost(torch.from_numpy(depth))
    # read: 9 logits, depth, out, grad; written: 9 logit and 1 depth
    # gradients, a pixel
    assert nbytes == 4 * (9 + 3 + 10) * N * H * W == logits.nbytes \
        + 3 * depth.nbytes + 10 * depth.nbytes
    assert flops == 90 * N * H * W
    ref = chip_smoke.Case("propagation_blend_backward", "", 1, None, None,
                          1e-5, nbytes, flops)
    assert T.bound_ms(nbytes, flops) == pytest.approx(ref.bound_ms,
                                                      rel=1e-12)


def test_digest_hashes_the_contiguous_bytes_of_each_output():
    from tdvnet_torch.tools import time_depthops as T

    a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    b = np.full((3,), np.nan, np.float32)
    view = torch.from_numpy(a).permute(0, 2, 1)      # not contiguous
    want = lambda *xs: hashlib.sha256(b"".join(
        np.ascontiguousarray(x).tobytes() for x in xs)).hexdigest()[:16]
    assert T.digest(view) == want(a.transpose(0, 2, 1))
    assert T.digest((view, torch.from_numpy(b))) == \
        want(a.transpose(0, 2, 1), b)
    assert T.digest(torch.from_numpy(a)) != T.digest(view)


def test_edge_inputs_are_the_edge_cases_as_the_main_path_hands_them():
    from tdvnet_torch.kernels.propagation import propagation_blend_ref
    from tdvnet_torch.tools import time_depthops as T

    assert T.edge_module() is E
    fwd, bwd = T.edge_inputs(torch.device("cpu"))
    assert len(fwd) == len(E.SOFTARGMAX_CASES)
    assert len(bwd) == len(E.BLEND_CASES)
    for name, *_ in E.SOFTARGMAX_CASES:
        cost, dv, _ = E.softargmax_case(name)
        got = fwd[f"edge {name}"]
        np.testing.assert_array_equal(got[0].numpy(), cost)
        np.testing.assert_array_equal(got[1].numpy(), dv)
    for name, _, _ in E.BLEND_CASES:
        grad, logits, depth = E.blend_case(name)
        g, view, d, out = bwd[f"edge {name}"]
        # the logits as the permuted NCHW view PropagationNet hands over
        assert view.shape == (logits.shape[0], *logits.shape[2:], 9)
        assert view.stride()[3] == logits.shape[2] * logits.shape[3]
        np.testing.assert_array_equal(view.numpy(),
                                      logits.transpose(0, 2, 3, 1))
        np.testing.assert_array_equal(g.numpy(), grad)
        assert torch.equal(out, propagation_blend_ref(view, d))


def test_inputs_of_reads_the_arguments_a_case_closes_over():
    import chip_smoke
    from tdvnet_torch.tools import time_depthops as T

    args = (torch.zeros(1, 2, 3, 4), torch.ones(2))
    case = chip_smoke.Case("softargmax_depth", "", 1,
                           lambda a=args: a[0].sum(), lambda a=args: None,
                           1e-5, 0, 0)
    assert T._inputs_of(case) is args
