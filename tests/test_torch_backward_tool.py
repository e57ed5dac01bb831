"""The helpers of `tdvnet_torch.tools.time_backward` on the CPU: the capture
of the backward wrappers' calls (and their restoration), the synthetic
gradients, the byte bounds and the digests. The timing itself needs the
card."""
import pytest
import torch

from tests._torch_helpers import torch_one_thread  # noqa: F401

from tdvnet_torch.kernels import groupnorm, segmax, trilinear, variance
from tdvnet_torch.tools import time_backward as tb


def _segmax_args():
    gen = torch.Generator().manual_seed(0)
    P, C, n_seg = 10, 4, 5
    y = torch.randn(P, C, generator=gen)
    seg = torch.randint(0, n_seg, (P,), generator=gen)
    pooled = torch.randn(n_seg, C, generator=gen)
    return (torch.randn(P, 2 * C, generator=gen), y, pooled, seg, True)


def test_capture_records_the_first_call_of_each_shape_and_restores():
    originals = [getattr(m, n) for m, n in (
        (variance, "source_variance_backward"),
        (trilinear, "trilinear_sample_backward"),
        (segmax, "gather_concat_backward"),
        (groupnorm, "masked_group_norm_backward"))]
    args = _segmax_args()
    calls = {}
    with tb.capture_backward(calls):
        assert segmax.gather_concat_backward is not originals[2]
        gy, gp = segmax.gather_concat_backward(*args)
        segmax.gather_concat_backward(*args)             # same shape
        segmax.gather_concat_backward(args[0][:6].contiguous(),
                                      args[1][:6].contiguous(), args[2],
                                      args[3][:6].contiguous(), True)
    assert [getattr(m, n) for m, n in (
        (variance, "source_variance_backward"),
        (trilinear, "trilinear_sample_backward"),
        (segmax, "gather_concat_backward"),
        (groupnorm, "masked_group_norm_backward"))] == originals
    assert len(calls) == 2
    name, got, kw = next(iter(calls.values()))
    assert name == "gather_concat_backward" and kw == {}
    assert got[0] is not args[0] and torch.equal(got[0], args[0])
    want = segmax.gather_concat_backward_ref(*args)
    assert torch.equal(gy, want[0]) and torch.equal(gp, want[1])


def test_synthetic_calls_replace_the_gradient_only():
    args = _segmax_args()
    calls = {"k": ("gather_concat_backward", args, {"x": 1})}
    syn = tb.synthetic_like(calls, seed=3)["k"]
    assert syn[0] == "gather_concat_backward" and syn[2] == {"x": 1}
    assert syn[1][0].shape == args[0].shape
    assert not torch.equal(syn[1][0], args[0])
    assert all(a is b for a, b in zip(syn[1][1:], args[1:]))
    again = tb.synthetic_like(calls, seed=3)["k"][1][0]
    assert torch.equal(again, syn[1][0])


@pytest.mark.parametrize("name", ["source_variance_backward",
                                  "trilinear_sample_backward",
                                  "gather_concat_backward",
                                  "masked_group_norm_backward"])
def test_byte_bounds_count_inputs_once_and_outputs_once(name):
    f = lambda *s: torch.zeros(*s)
    if name == "source_variance_backward":
        R, P, C, N, S = 2, 10, 8, 3, 2
        args = (f(R, P, C), f(R, P, C), f(R, P, 3), f(N, 4, 5, C),
                torch.zeros(R, S, dtype=torch.int64),
                torch.ones(R, S, dtype=torch.bool), f(N, 3, 4), (16, 20))
        want = 4 * (2 * R * P * C + R * P * 3 + 2 * N * 20 * C + R * S
                    + N * 12) + 8 * R * S
    elif name == "trilinear_sample_backward":
        args = (f(2, 7, 4), f(2, 7, 3), f(2, 3), 0.1, (2, 3, 4, 5, 4))
        want = 4 * (56 + 42 + 6 + 2 * 60 * 4)
    elif name == "gather_concat_backward":
        args = _segmax_args()
        want = 4 * (80 + 2 * 40 + 2 * 20) + 8 * 10
    else:
        B, C, V = 2, 8, 60
        for skip in (False, True):
            args = (f(B, C, 3, 4, 5), f(B, C, 3, 4, 5), f(B, 1, 3, 4, 5), 2,
                    f(C), f(B, C, 3, 4, 5), f(4, 4), 1e-5, not skip, skip)
            want = 4 * (B * C * V * (4 + skip) + B * V + 3 * C)
            assert tb.call_bytes(name, args) == want
        return
    assert tb.call_bytes(name, args) == want


def test_digest_follows_every_bit():
    a = torch.arange(12, dtype=torch.float32)
    assert tb.digest(a) == tb.digest(a.clone())
    b = a.clone()
    b[5] = torch.nextafter(b[5], torch.tensor(100.0))
    assert tb.digest(a) != tb.digest(b)
    assert tb.digest((a, None, a)) != tb.digest((a,))
