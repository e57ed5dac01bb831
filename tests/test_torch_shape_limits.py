"""Shapes that only the card's kernels once refused, on the CPU.

Channel counts that are not a multiple of 4: K6's forward kernel takes
one channel a lane there; K1/K2 and its backward, K6's backward, K3's
scatter and its backward, and K6-int8 read and write 4-channel groups, so
their wrappers add zero channels on the card and slice the real ones out
(`kernels/_launch.pad_channels`). That is exact because every
channel's arithmetic is its own: here each twin at the padded width,
sliced, gives the bits of the twin at the exact width (the card tests hold
the kernels to these twins at odd widths). And the whole model at a tiny
config with odd
widths against the JAX package: `infer_depth` and the loss of one n_iters=1
train step, from the same weights on the same batch (one JAX compile).

Soft-argmax past 384 planes: `tests/_kernel_edge_cases.py`'s 392- and
768-plane cases run through tests/test_torch_depthops_edges.py."""
import dataclasses

import numpy as np
import pytest
import torch

import _kernel_edge_cases as E
from _torch_helpers import both_batches, init_variables, n, t
from _torch_helpers import torch_one_thread  # noqa: F401 (autouse)

WIDTHS = (1, 6, 7)
# feat_dim 5: K1/K2 at 5 channels, K3's scatter at 2 * 5, the PointNet's
# pools at 4 * 5; the scene U-Net's first width is the PointNet's output
# (2 * feat_dim), its GroupNorm groups divide each width; K6 samples the
# three scales (10, 18, 30 channels) into slices at offsets 0, 10 and 28
ODD = {"model": {"feat_dim": 5, "unet_dims": (10, 18, 30),
                 "unet_groups": (2, 3, 3)}}
OFFSETS = ((0.05, 0.025), (0.025,))
LAM = 0.5


def _bits(x):
    x = x.contiguous()
    return x.view(torch.int32) if x.dtype == torch.float32 else \
        x.view(torch.int16) if x.dtype == torch.bfloat16 else x


def _same(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(_bits(a), _bits(b))


def _pad(x, C):
    from tdvnet_torch.kernels._launch import pad_channels, quad

    return pad_channels(x, quad(C))


def _variance_inputs(C):
    c = E.variance_case("nonfinite", C)
    P_all = E.projection_matrices(c["K"], c["rotmats"], c["tvecs"])
    return (t(c["pts"]).float(), t(c["feats"]).float(),
            t(c["src_idx"]), torch.from_numpy(c["src_mask"]),
            t(P_all).float(), c["img_size"])


@pytest.mark.parametrize("C", WIDTHS)
def test_padded_variance_twins_give_the_exact_width_bits(C):
    from tdvnet_torch.kernels.variance import (source_variance_backward_ref,
                                               source_variance_ref)

    pts, feats, idx, mask, P_all, img = _variance_inputs(C)
    var, mean = source_variance_ref(pts, feats, idx, mask, P_all, img, True)
    pvar, pmean = source_variance_ref(pts, _pad(feats, C), idx, mask, P_all,
                                      img, True)
    _same(pvar[..., :C], var)
    _same(pmean[..., :C], mean)
    # the zero channels' variance is 0 (NaN at a poisoned point)
    assert not pvar[..., C:].nan_to_num().any()
    g = torch.from_numpy(np.random.default_rng(C).normal(
        size=var.shape).astype(np.float32))
    want = source_variance_backward_ref(g, mean, pts, feats, idx, mask,
                                        P_all, img)
    got = source_variance_backward_ref(_pad(g, C), pmean, pts,
                                       _pad(feats, C), idx, mask, P_all, img)
    _same(got[..., :C], want)


@pytest.mark.parametrize("C", WIDTHS)
def test_padded_sampling_twins_give_the_exact_width_bits(C):
    """K6 into a slice of a wider output, its grid backward, and K6-int8
    into a slice, each at the padded width against the exact one."""
    from tdvnet_torch.kernels.trilinear import (
        trilinear_sample_backward_ref, trilinear_sample_i8_ref,
        trilinear_sample_ref)

    grid, pts, c0, cell = (t(x) if not isinstance(x, float) else x
                           for x in E.trilinear_forward_case("grid_edges", C))
    want = trilinear_sample_ref(grid, pts, c0, cell)
    _same(trilinear_sample_ref(_pad(grid, C), pts, c0, cell)[..., :C], want)
    g = torch.from_numpy(np.random.default_rng(C).normal(
        size=want.shape).astype(np.float32))
    shape = tuple(grid.shape)
    got = trilinear_sample_backward_ref(_pad(g, C), pts, c0, cell,
                                        shape[:-1] + (_pad(g, C).shape[-1],))
    _same(got[..., :C], trilinear_sample_backward_ref(g, pts, c0, cell,
                                                      shape))
    gi, sc, pi, ci, celli, off = E.i8_case("grid_edges", C)
    gi, sc, pi, ci = t(gi).to(torch.int8), t(sc), t(pi), t(ci)
    want = trilinear_sample_i8_ref(gi, sc, pi, ci, celli, off)
    _same(trilinear_sample_i8_ref(_pad(gi, C), _pad(sc, C), pi, ci, celli,
                                  off)[..., :C], want)


@pytest.mark.parametrize("C", (2, 6, 10))
def test_padded_scatter_twins_give_the_exact_width_bits(C):
    from tdvnet_torch.kernels.voxelize import (
        VoxelGrid, scatter_anchors_to_dense_backward_ref,
        scatter_anchors_to_dense_ref)

    feats, idx3, scene, valid, grid_size, B = E.scatter_case("three_scenes")
    feats = t(np.random.default_rng(C).normal(
        size=(feats.shape[0], C)).astype(np.float32))
    vg = VoxelGrid(None, t(idx3), t(scene), None, torch.from_numpy(valid),
                   None, None, None, None, None, None)
    dense, occ = scatter_anchors_to_dense_ref(feats, vg, grid_size, B)
    pdense, pocc = scatter_anchors_to_dense_ref(_pad(feats, C), vg,
                                                grid_size, B)
    _same(pdense[..., :C], dense)
    _same(pocc, occ)
    g = torch.from_numpy(np.random.default_rng(C + 1).normal(
        size=dense.shape).astype(np.float32))
    _same(scatter_anchors_to_dense_backward_ref(_pad(g, C), vg, grid_size,
                                                B)[:, :C],
          scatter_anchors_to_dense_backward_ref(g, vg, grid_size, B))


# ------------------------------------------------- the odd-width model
@pytest.fixture(scope="module")
def odd_runs():
    """Both packages at the odd-width tiny config from the same variables
    on the same batch: JAX's `infer_depth` and n_iters=1 train-mode loss
    in one jitted call, the port's `infer_depth` and one n_iters=1
    `make_train_step`."""
    import jax

    import tdvnet.config as JC
    from _torch_helpers import jax_tiny_config
    from tdvnet.models.threedvnet import ThreeDVNet as J
    from tdvnet_torch.config import _overlay, tiny_test_config
    from tdvnet_torch.models.threedvnet import ThreeDVNet as T
    from tdvnet_torch.train import loop as TL
    from tdvnet_torch.weights import load_flax_into

    cfg_j = JC._overlay(jax_tiny_config(), ODD)
    cfg_t = _overlay(tiny_test_config(), ODD)
    jb, tb = both_batches(cfg_j, [4])
    jm = J(cfg_j.model)
    offs = list(cfg_j.train.offsets)
    variables = init_variables(jm, jb, offsets=offs, n_iters=1, lam=0.0,
                               train=False, seed=3)

    def jax_side(v):
        depth = jm.apply(v, jb, OFFSETS, method=J.infer_depth)
        out, _ = jm.apply(v, jb, offsets=offs, n_iters=1, lam=LAM,
                          train=True, with_metrics=False,
                          backbone_train=False, mutable=["batch_stats"])
        return depth, out["loss"], out["loss_2d"]

    depth_j, loss_j, loss2d_j = jax.jit(jax_side)(variables)

    def port_model():
        m = T(cfg_t.model)
        load_flax_into(m, variables)
        return m

    with torch.no_grad():
        depth_t = port_model().eval().infer_depth(tb, OFFSETS)
    model = port_model()
    ts = TL.TrainState(model, TL.make_optimizer(cfg_t, model, 1))
    # oneDNN's fp32 convolution backward (tests/test_torch_train.py)
    with torch.backends.mkldnn.flags(enabled=False):
        _, mets = TL.make_train_step(model, cfg_t, 1)(ts, tb, LAM)
    return dict(depth_j=np.asarray(depth_j), depth_t=n(depth_t),
                loss_j=(float(loss_j), float(loss2d_j)),
                loss_t=(float(mets["loss"]), float(mets["loss_2d"])),
                model=model)


def test_odd_width_infer_depth_matches_jax(odd_runs):
    # tests/test_torch_infer.py's limits for the chain (a point may change
    # voxel)
    d = np.abs(odd_runs["depth_j"] - odd_runs["depth_t"])
    assert np.isfinite(odd_runs["depth_t"]).all()
    assert np.median(d) < 1e-5 and np.percentile(d, 99) < 1e-4, \
        (np.median(d), np.percentile(d, 99))


def test_odd_width_train_step_loss_matches_jax(odd_runs):
    # tests/test_torch_train_refine.py's loss limit
    for a, b in zip(odd_runs["loss_t"], odd_runs["loss_j"]):
        assert abs(a - b) <= 1e-5 * abs(b), (a, b)
    grads = [p.grad for p in odd_runs["model"].parameters()
             if p.grad is not None]
    assert grads and all(torch.isfinite(g).all() for g in grads)
    assert odd_runs["model"].pointnet.fc_out.weight.grad.abs().sum() > 0


def test_odd_width_config_is_the_jax_packages():
    import tdvnet.config as JC
    from _torch_helpers import jax_tiny_config
    from tdvnet_torch.config import _overlay, tiny_test_config

    j = dataclasses.asdict(JC._overlay(jax_tiny_config(), ODD).model)
    p = dataclasses.asdict(_overlay(tiny_test_config(), ODD).model)
    for k in p:
        if k != "dtype":
            assert p[k] == j[k], k
