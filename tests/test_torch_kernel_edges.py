"""The edges that the brick-binned trilinear backward and the map-based
dense scatter must keep, on the CPU: each twin against the JAX function it
stands for, on the seeded numpy inputs of `_kernel_edge_cases` (the card
tests in tests/test_torch_cuda.py hold the kernels to these twins on the
same inputs); and a plain model of the backward's binning (each point's
entries per brick, each brick summing only its own nodes) against the
twin."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _kernel_edge_cases as E
from _torch_helpers import n, t
from _torch_helpers import torch_one_thread  # noqa: F401 (autouse)

# relative L2 of an fp32 grid gradient against another fp32 sum of the same
# terms (both sides read 0 to 3.4e-8 on these inputs)
GRAD_RTOL = 1e-6


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jax_grid_grad(grad, pts, c0, cell, shape):
    """jax.vjp of the oct path that training samples through
    (tdvnet/models/hypothesis.py:122) with respect to the grid."""
    from tdvnet.ops.sampling import (pack_trilinear_octs,
                                     trilinear_sample_octs)

    B, X, Y, Z, C = shape

    def sample(gr):
        q = (jnp.asarray(pts) - jnp.asarray(c0)[:, None]) / cell
        octs = jax.vmap(pack_trilinear_octs)(gr)
        return jax.vmap(trilinear_sample_octs, in_axes=(0, 0, None))(
            octs, q, (X, Y, Z))

    _, vjp = jax.vjp(sample, jnp.zeros(shape, jnp.float32))
    return np.asarray(vjp(jnp.asarray(grad))[0])


@pytest.mark.parametrize("case", E.TRILINEAR_CASES)
def test_trilinear_backward_ref_matches_jax_at_edges(case):
    from tdvnet_torch.kernels.trilinear import trilinear_sample_backward_ref

    grad, pts, c0, cell, shape = E.trilinear_case(case)
    got = n(trilinear_sample_backward_ref(t(grad), t(pts), t(c0), cell,
                                          shape))
    assert got.shape == shape
    keep = E.finite_points(pts).all(0)
    if case == "nonfinite":
        # the one deliberate difference: JAX's gradient of a point with a
        # non-finite coordinate is NaN (XLA converts floor(NaN) to cell 0,
        # and inf - inf weights times a zero mask stay NaN); the twin and
        # the kernel take nothing from it, as if it were absent
        assert not keep.all() and np.isfinite(got).all()
    want = _jax_grid_grad(grad[:, keep], pts[:, keep], c0, cell, shape)
    if case == "no_points":
        assert not got.any() and not want.any()
        return
    assert np.abs(want).max() > 0
    assert _rel_l2(got, want) < GRAD_RTOL
    if case == "grid_edges":
        # taps on the grid's faces, from both sides, took gradient
        X, Y, Z = shape[1:4]
        for face in (want[:, 0], want[:, X - 1], want[:, :, 0],
                     want[:, :, Y - 1], want[..., 0, :], want[..., Z - 1, :]):
            assert np.abs(face).max() > 0


def _brick_model(grad, pts, c0, cell, shape, brick=8):
    """The kernel's algorithm in numpy: an entry per (point, brick that its
    in-grid taps touch), then each brick summing the taps of its entries
    that fall in its own nodes. Returns (d grid, entries per point that
    takes gradient)."""
    B, X, Y, Z, C = shape
    dims = np.array([X, Y, Z])
    sizes = np.array([brick] * 3)
    q = ((pts - c0[:, None]) / np.float32(cell)).astype(np.float32)
    out = np.zeros(shape, np.float32)
    n_entries = n_taking = 0
    for b in range(B):
        for p in range(pts.shape[1]):
            if not np.isfinite(q[b, p]).all():
                continue
            f = np.floor(q[b, p])
            if ((f < -1) | (f > dims - 1)).any():
                continue
            n_taking += 1
            a0 = f.astype(int)
            w = q[b, p] - f
            lo = np.maximum(a0, 0)
            hi = np.minimum(a0 + 1, dims - 1)
            bricks = [range(lo[i] // sizes[i], hi[i] // sizes[i] + 1)
                      for i in range(3)]
            for bx in bricks[0]:
                for by in bricks[1]:
                    for bz in bricks[2]:
                        n_entries += 1
                        start = np.array([bx, by, bz]) * sizes
                        for d in np.ndindex(2, 2, 2):
                            node = a0 + d
                            if ((node < start) | (node >= start + sizes)
                                    | (node < 0) | (node >= dims)).any():
                                continue
                            wt = np.float32(1)
                            for i in range(3):
                                wt *= w[i] if d[i] else 1 - w[i]
                            out[(b, *node)] += grad[b, p] * wt
    return out, n_entries / max(n_taking, 1)


@pytest.mark.parametrize("case", ["brick_faces", "grid_edges", "one_cell"])
def test_brick_binning_model_matches_twin(case):
    from tdvnet_torch.kernels.trilinear import (brick_count,
                                                trilinear_sample_backward_ref)

    grad, pts, c0, cell, shape = E.trilinear_case(case)
    if case == "one_cell":
        grad, pts = grad[:, :200], pts[:, :200]
    got, per_point = _brick_model(grad, pts, c0, cell, shape)
    want = n(trilinear_sample_backward_ref(t(grad), t(pts), t(c0), cell,
                                           shape))
    assert _rel_l2(got, want) < GRAD_RTOL
    # every point of the corner cell touches eight bricks; of the others,
    # only those whose anchor lies on a brick's high face touch more than one
    if case == "one_cell":
        assert per_point == 8
    else:
        assert (1 < per_point < 8) if case == "brick_faces" else \
            (1 <= per_point < 8)
    B, X, Y, Z, _ = shape
    assert brick_count(shape) == B * -(-X // 8) * 2 * 2


@pytest.mark.parametrize("case", E.SCATTER_CASES)
def test_scatter_ref_matches_jax_at_edges(case):
    from tdvnet.ops import voxelize as J
    from tdvnet_torch.kernels.voxelize import (VoxelGrid,
                                               scatter_anchors_to_dense_ref)

    feats, idx3, scene, valid, grid, B = E.scatter_case(case)
    jvg = J.VoxelGrid(None, jnp.asarray(idx3, jnp.int32),
                      jnp.asarray(scene, jnp.int32), None,
                      jnp.asarray(valid), None, None, None, None, None, None)
    tvg = VoxelGrid(None, torch.from_numpy(idx3), torch.from_numpy(scene),
                    None, torch.from_numpy(valid), None, None, None, None,
                    None, None)
    da, oa = J.scatter_anchors_to_dense(jnp.asarray(feats), jvg, grid, B)
    db, ob = scatter_anchors_to_dense_ref(t(feats), tvg, grid, B)
    np.testing.assert_array_equal(np.asarray(da), n(db))
    np.testing.assert_array_equal(np.asarray(oa), n(ob))
    assert n(ob).shape == (B, *grid, 1)
    assert int(n(ob).sum()) == int(valid.sum())
    if case == "last_cells":
        assert (n(ob)[:, -1, -1, -1, 0] == 1).all()
