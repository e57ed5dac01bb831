"""The soft-argmax (K8b) and the propagation blend's backward (K8a) at
their edges, on the CPU: the twins against the JAX package's XLA forms
(the forward and `jax.vjp` of tdvnet/models/mvsnet.py:89-93 and
tdvnet/models/upsampling.py:17-45) on the seeded numpy inputs of
`_kernel_edge_cases` (the card tests in tests/test_torch_cuda.py hold the
kernels to these twins on the same inputs); and the backward kernel's
gather rule (`clamp_preimage` per axis, in csrc/propagation_blend_backward.cu)
against the edge clamp of `unfold3x3`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _kernel_edge_cases as E
from _torch_helpers import n, t
from _torch_helpers import torch_one_thread  # noqa: F401 (autouse)

# tests/test_torch_kernels.py's limits for these twins against XLA: a
# softmax of 9 or of D planes and a 9- or D-term sum in fp32
RTOL, ATOL = 2e-6, 1e-6


def _jax_softargmax(cost, dv):
    """tdvnet/models/mvsnet.py:89-93."""
    prob = jax.nn.softmax(-cost, axis=1)
    return jnp.sum(prob * dv[None, :, None, None], axis=1)


@pytest.mark.parametrize("case", [c[0] for c in E.SOFTARGMAX_CASES])
def test_softargmax_twins_match_xla_form_at_edges(case):
    from tdvnet_torch.kernels.softargmax import (
        softargmax_depth_backward_ref, softargmax_depth_ref)

    cost, dv, g = E.softargmax_case(case)
    dvj = jnp.asarray(dv)
    want, vjp = jax.vjp(lambda c: _jax_softargmax(c, dvj), jnp.asarray(cost))
    (gwant,) = vjp(jnp.asarray(g))
    depth = softargmax_depth_ref(t(cost), t(dv))
    # NaN where XLA has NaN (assert_allclose matches NaN and inf places)
    np.testing.assert_allclose(n(depth), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    got = softargmax_depth_backward_ref(t(g), t(cost), t(dv), depth)
    # -g p_d (dv_d - depth) against XLA's softmax VJP p_d (g dv_d - sum_j
    # p_j g dv_j): each forms a difference of terms of up to max|g| max|dv|,
    # so its rounding is absolute at that scale
    scale = float(np.abs(g).max() * np.abs(dv).max())
    np.testing.assert_allclose(n(got), np.asarray(gwant), rtol=RTOL,
                               atol=ATOL * scale)
    if case in ("infinities", "nan"):
        assert np.isnan(n(depth)).any() and np.isfinite(n(depth)).any()


def _jax_blend(lg, d):
    """tdvnet/models/upsampling.py:44-45 over `unfold3x3` (:17-28)."""
    from tdvnet.models.upsampling import unfold3x3

    return jnp.sum(jax.nn.softmax(lg, axis=-1) * unfold3x3(d), axis=-1)


@pytest.mark.parametrize("case", [c[0] for c in E.BLEND_CASES])
def test_blend_backward_twin_matches_xla_vjp_at_edges(case):
    from tdvnet_torch.kernels import propagation_blend_backward
    from tdvnet_torch.kernels.propagation import propagation_blend_ref

    grad, logits, depth = E.blend_case(case)
    want, vjp = jax.vjp(_jax_blend, jnp.asarray(logits.transpose(0, 2, 3, 1)),
                        jnp.asarray(depth))
    gl_want, gd_want = vjp(jnp.asarray(grad))
    # the logits as the permuted view of an NCHW tensor, as PropagationNet
    # hands them over
    view = t(logits).permute(0, 2, 3, 1)
    out = propagation_blend_ref(view, t(depth))
    np.testing.assert_allclose(n(out), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    gl, gd = propagation_blend_backward(t(grad), view, t(depth), out)
    # g w_k (u_k - out) against XLA's softmax VJP w_k (g u_k - sum_j w_j g
    # u_j): each forms a difference of terms of up to max|g| max|u|, so its
    # rounding is absolute at that scale
    scale = float(np.abs(grad).max() * np.abs(depth).max())
    np.testing.assert_allclose(n(gl), np.asarray(gl_want), rtol=RTOL,
                               atol=ATOL * scale)
    np.testing.assert_allclose(n(gd), np.asarray(gd_want), rtol=RTOL,
                               atol=ATOL)


def _clamp_preimage(t, size):
    """csrc/propagation_blend_backward.cu `clamp_preimage`: the three
    (source, tap) pairs whose clamped neighbour along one axis is `t`."""
    one, first, last = size == 1, t == 0, t == size - 1
    if one:
        return [(0, 1), (0, 0), (0, 2)]
    if first:
        return [(1, 0), (0, 1), (0, 0)]
    if last:
        return [(size - 1, 1), (size - 2, 2), (size - 1, 2)]
    return [(t + 1, 0), (t, 1), (t - 1, 2)]


def _walk_preimage(t, size):
    """The same pairs in the order of a walk over the taps d = 0, 1, 2 and
    then the clamped-up and clamped-down taps (the order in which the
    two-pass form summed them)."""
    out = [(t + 1 - d, d) for d in range(3) if 0 <= t + 1 - d < size]
    if t == 0:
        out.append((0, 0))
    if t == size - 1:
        out.append((size - 1, 2))
    return out


@pytest.mark.parametrize("case", [c[0] for c in E.BLEND_CASES])
def test_blend_backward_gather_visits_each_clamped_tap_once(case):
    """The kernel's depth gradient gathers, for each pixel, the (source
    pixel, tap) pairs of its rows' and columns' preimages in the two-pass
    form's order: exactly the pairs whose edge-clamped 3x3 tap
    (`unfold3x3`) reads that pixel, each once, every source pixel in the
    tile's one-pixel halo."""
    _, H, W = dict((c[0], c) for c in E.BLEND_CASES)[case]
    for size in (H, W):
        for t in range(size):
            assert _clamp_preimage(t, size) == _walk_preimage(t, size)
    want = {}
    for y in range(H):
        for x in range(W):
            for dy in range(3):
                for dx in range(3):
                    yy = min(max(y + dy - 1, 0), H - 1)
                    xx = min(max(x + dx - 1, 0), W - 1)
                    want.setdefault((yy, xx), []).append((y, x, 3 * dy + dx))
    for y in range(H):
        for x in range(W):
            got = [(sy, sx, 3 * ty + tx) for sy, ty in _clamp_preimage(y, H)
                   for sx, tx in _clamp_preimage(x, W)]
            assert sorted(got) == sorted(want.get((y, x), []))
            assert all(abs(sy - y) <= 1 and abs(sx - x) <= 1
                       for sy, sx, _ in got)
