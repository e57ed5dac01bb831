"""The port's n_iters >= 1 training step against the JAX package's, on the
CPU.

The backward twins of the scene kernels (the dense scatter, the PointNet's
max pool and concat-back, the masked GroupNorm with its three tails, the
fp32 scene sampling) against `torch.autograd` of their forward twins and
against `jax.vjp` of the JAX functions, on seeded numpy inputs; and one
tiny-config n_iters=1 step of `tdvnet_torch.train.loop.make_train_step`
against `tdvnet.train.loop.make_train_step` from the same initial
variables on the same batch at lambda 0.5: the loss, every gradient leaf
(the PointNet's, the scene U-Net's and the decoder's included), the
parameters after Adam and the running statistics. The kernels themselves
are held to these twins on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import (adam_grads, both_batches, init_variables,
                            jax_tiny_config, n, t)
from _torch_helpers import torch_one_thread  # noqa: F401 (autouse)

# relative L2 of a gradient leaf (fp32 sums in another order on each side)
GRAD_RTOL = 1e-4
# refine_half and its guide, the FPN's half-scale head: JAX's fp32 is ~1e-2
# off a float64 rerun of the step there (its one-pass train-mode BatchNorm
# variance in refine_half, as GRAD_RTOL_REFINE_FULL in
# tests/test_torch_train.py), where the port's fp32 is 1e-5 off;
# test_refine_step_matches_its_float64_rerun holds the port there
GRAD_RTOL_HALF = 1.5e-2
HALF = ("refine_half.", "mvsnet.fpn.lateral0.", "mvsnet.fpn.smooth0.")
# every leaf whose gradient passes through the scene U-Net's masked
# GroupNorms: the JAX package takes its variance in one pass, E[x^2] -
# E[x]^2 in fp32, and is up to 7.4e-4 off a float64 rerun there; the port
# sums the statistics in float64. Its own fp32 step is within 2e-5 of the
# rerun with four torch threads, but up to 6.2e-4 with the one thread
# these tests run (torch's single-threaded CPU sums along the scene path);
# the card's step is held to its float64 rerun in chip_smoke.py phase 9b
GRAD_RTOL_SCENE = 1e-3
SCENE = ("mvsnet.", "pointnet.", "scene_unet.", "decoder.")
# the last cost conv's bias shifts every plane's cost alike, which the
# soft-argmax does not see, and the decoder's last conv bias shifts every
# hypothesis's score alike, which its softmax does not see: their gradients
# are zero in exact arithmetic and rounding noise on either side
ZERO_GRAD = ("mvsnet.cost_reg.Conv_0.bias", "decoder.Conv_3.bias")
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
NOISE_SHARE = 0.06
# a twin against torch.autograd of its forward twin, in float64
TWIN_RTOL = 1e-12
LAM = 0.5


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _grad_rtol(key):
    if key.startswith(HALF):
        return GRAD_RTOL_HALF
    return GRAD_RTOL_SCENE if key.startswith(SCENE) else GRAD_RTOL


# ------------------------------------------------------------ backward twins
@pytest.fixture(scope="module")
def voxel_case():
    """Points of two scenes in a 16^3 grid of 0.08 m (some outside it, a
    tenth invalid), voxelized by both packages into 64 anchors (so some
    points overflow into the dump slot)."""
    from tdvnet.ops import voxelize as JV
    from tdvnet_torch.kernels.voxelize import voxelize_ref

    rng = np.random.default_rng(21)
    pts = (rng.random((300, 3)) * 1.5 - 0.1).astype(np.float32)
    scene = (np.arange(300) // 150).astype(np.int32)
    valid = rng.random(300) > 0.1
    args = (0.08, (16, 16, 16), 64, 2)
    vg_j = JV.voxelize(jnp.asarray(pts), jnp.asarray(scene),
                       jnp.asarray(valid), *args)
    vg_t = voxelize_ref(t(pts), t(scene), t(valid), *args)
    np.testing.assert_array_equal(np.asarray(vg_j.point2anchor),
                                  n(vg_t.point2anchor))
    return vg_j, vg_t, rng


def test_scatter_backward_ref_matches_autograd_and_jax(voxel_case):
    from tdvnet.ops import voxelize as JV
    from tdvnet_torch import kernels as K
    from tdvnet_torch.kernels.voxelize import (
        scatter_anchors_to_dense_backward_ref, scatter_anchors_to_dense_ref)

    vg_j, vg_t, rng = voxel_case
    feats = rng.normal(size=(64, 8)).astype(np.float32)
    g = rng.normal(size=(2, 16, 16, 16, 8)).astype(np.float32)
    assert not bool(vg_t.anchor_valid.all()) or int(vg_t.n_overflow) > 0

    _, vjp = jax.vjp(lambda f: JV.scatter_anchors_to_dense(
        f, vg_j, (16, 16, 16), 2)[0], jnp.asarray(feats))
    (gj,) = vjp(jnp.asarray(g))
    f64 = t(feats).double().requires_grad_()
    dense, occ = scatter_anchors_to_dense_ref(f64, vg_t, (16, 16, 16), 2)
    (ga,) = torch.autograd.grad(dense, f64, t(g).double())
    gh = scatter_anchors_to_dense_backward_ref(t(g), vg_t, (16, 16, 16), 2)
    assert _rel_l2(n(gh), n(ga)) < TWIN_RTOL
    np.testing.assert_array_equal(n(gh), np.asarray(gj))
    # the wrapper differentiates through its twin on the CPU
    f32 = t(feats).requires_grad_()
    K.scatter_anchors_to_dense(f32, vg_t, (16, 16, 16), 2)[0].backward(t(g))
    np.testing.assert_array_equal(n(f32.grad), n(gh))


def _pool_case(rng):
    """Rows of 6 segments: segment 1 holds two valid rows tied at its
    maximum in channel 0, segment 4 only invalid rows, segment 5 none."""
    P, C = 40, 8
    y = rng.normal(size=(P, C)).astype(np.float32)
    seg = rng.integers(0, 4, P)
    valid = rng.random(P) > 0.2
    seg[:2], valid[:2], y[:2, 0] = 1, True, 9.0
    seg[2:5], valid[2:5] = 4, False
    return y, seg, valid, 6


def test_segment_max_backward_ref_matches_autograd_and_jax():
    from tdvnet.models.pointnet import NEG, _segmax
    from tdvnet_torch.kernels.segmax import (segment_max_backward_ref,
                                             segment_max_ref)

    rng = np.random.default_rng(22)
    y, seg, valid, n_seg = _pool_case(rng)
    g = rng.normal(size=(n_seg, y.shape[1])).astype(np.float32)

    def pool(yy):             # tdvnet/models/pointnet.py:51-52
        return _segmax(jnp.where(jnp.asarray(valid)[:, None], yy, NEG),
                       jnp.asarray(seg), n_seg)

    pooled_j, vjp = jax.vjp(pool, jnp.asarray(y))
    (gj,) = vjp(jnp.asarray(g))
    y64 = t(y).double().requires_grad_()
    pooled = segment_max_ref(y64, t(seg), t(valid), n_seg)
    (ga,) = torch.autograd.grad(pooled, y64, t(g).double())
    gh = segment_max_backward_ref(t(g), t(y), t(seg), t(valid),
                                  pooled.detach().float())
    np.testing.assert_array_equal(n(pooled.float()), np.asarray(pooled_j))
    assert _rel_l2(n(gh), n(ga)) < TWIN_RTOL
    np.testing.assert_allclose(n(gh), np.asarray(gj), rtol=1e-6, atol=0)
    # the tie splits evenly; the empty segments pass nothing on
    assert float(gh[0, 0]) == float(gh[1, 0]) == float(g[1, 0]) / 2
    assert not bool(gh[2:5].any()) and n(pooled)[4:].max() == 0


@pytest.mark.parametrize("relu", [True, False])
def test_gather_concat_backward_ref_matches_autograd_and_jax(relu):
    from tdvnet_torch.kernels.segmax import (gather_concat_backward_ref,
                                             gather_concat_ref,
                                             segment_max_ref)

    rng = np.random.default_rng(23)
    y, seg, valid, n_seg = _pool_case(rng)
    pooled = n(segment_max_ref(t(y), t(seg), t(valid), n_seg))
    g = rng.normal(size=(y.shape[0], 2 * y.shape[1])).astype(np.float32)

    def back(yy, pp):         # tdvnet/models/pointnet.py:53-55
        out = jnp.concatenate([yy, pp.at[jnp.asarray(seg)].get()], axis=-1)
        return jax.nn.relu(out) if relu else out

    _, vjp = jax.vjp(back, jnp.asarray(y), jnp.asarray(pooled))
    gy_j, gp_j = vjp(jnp.asarray(g))
    y64 = t(y).double().requires_grad_()
    p64 = t(pooled).double().requires_grad_()
    out = gather_concat_ref(y64, p64, t(seg), relu)
    gy_a, gp_a = torch.autograd.grad(out, (y64, p64), t(g).double())
    gy_h, gp_h = gather_concat_backward_ref(t(g), t(y), t(pooled), t(seg),
                                            relu)
    assert _rel_l2(n(gy_h), n(gy_a)) < TWIN_RTOL
    assert _rel_l2(n(gp_h), n(gp_a)) < 1e-6        # fp32 sums
    np.testing.assert_array_equal(n(gy_h), np.asarray(gy_j))
    assert _rel_l2(n(gp_h), np.asarray(gp_j)) < 1e-6


@pytest.mark.parametrize("tail", ["plain", "relu", "skip"])
def test_masked_group_norm_backward_ref_matches_autograd_and_jax(tail):
    from tdvnet.models.layers import masked_group_norm as j_gn
    from tdvnet_torch.kernels.groupnorm import (masked_group_norm_backward_ref,
                                                masked_group_norm_ref)

    rng = np.random.default_rng(24)
    B, C, G, d = 2, 8, 4, (3, 4, 5)
    x = (rng.normal(size=(B, C, *d)) * 2 + 1).astype(np.float32)
    mask = (rng.random((B, 1, *d)) > 0.4).astype(np.float32)
    mask[1, :, 2:] = 0                # the two scenes differ in their count
    x *= mask
    w = rng.normal(size=C).astype(np.float32)
    b = rng.normal(size=C).astype(np.float32)
    skip = (rng.normal(size=(B, C, *d)) * mask).astype(np.float32)
    g = rng.normal(size=(B, C, *d)).astype(np.float32)
    cl = lambda a: jnp.asarray(np.moveaxis(a, 1, -1))     # NCDHW -> NDHWC

    def gn(xx, ww, bb, ss):     # tdvnet/models/scene_unet.py's tails
        m = cl(mask)
        y = j_gn(xx, m, G, ww, bb)
        if tail == "relu":
            return jax.nn.relu(y) * m
        return jax.nn.relu(y + ss) * m if tail == "skip" else y

    _, vjp = jax.vjp(gn, cl(x), jnp.asarray(w), jnp.asarray(b), cl(skip))
    gj = vjp(cl(g))
    gj = (np.moveaxis(np.asarray(gj[0]), -1, 1), gj[1], gj[2],
          np.moveaxis(np.asarray(gj[3]), -1, 1))
    kw = {"relu": tail == "relu"}
    ins = [t(a).double().requires_grad_() for a in (x, w, b, skip)]
    out = masked_group_norm_ref(ins[0], t(mask).double(), G, ins[1], ins[2],
                                skip=ins[3] if tail == "skip" else None, **kw)
    ga = torch.autograd.grad(out, ins, t(g).double(), allow_unused=True)
    out32 = masked_group_norm_ref(t(x), t(mask), G, t(w), t(b),
                                  skip=t(skip) if tail == "skip" else None,
                                  **kw)
    gh = masked_group_norm_backward_ref(t(g), t(x), t(mask), G, t(w), out32,
                                        skip=tail == "skip", **kw)
    for i, name in enumerate(("x", "weight", "bias", "skip")):
        if tail != "skip" and name == "skip":
            assert gh[i] is None and ga[i] is None
            continue
        assert _rel_l2(n(gh[i]), n(ga[i])) < 1e-6, name     # fp32 vs f64
        assert _rel_l2(n(gh[i]), np.asarray(gj[i])) < GRAD_RTOL, name
    # float64 in, float64 out: the twin is exact against autograd there
    gh64 = masked_group_norm_backward_ref(
        t(g).double(), t(x).double(), t(mask).double(), G, t(w).double(),
        out.detach(), skip=tail == "skip", **kw)
    assert _rel_l2(n(gh64[0]), n(ga[0])) < TWIN_RTOL


def test_trilinear_backward_ref_matches_autograd_and_jax():
    from tdvnet.ops.sampling import (pack_trilinear_octs,
                                     trilinear_sample_octs)
    from tdvnet_torch import kernels as K
    from tdvnet_torch.kernels.trilinear import (trilinear_sample_backward_ref,
                                                trilinear_sample_ref,
                                                trilinear_sample_scale)

    rng = np.random.default_rng(25)
    B, dims, C, cell = 2, (4, 5, 6), 8, 0.5
    grid = rng.normal(size=(B, *dims, C)).astype(np.float32)
    c0 = (rng.normal(size=(B, 3)) * 0.1).astype(np.float32)
    # a margin of two cells around the grid: some points outside it, some
    # with only part of their footprint inside
    pts = (c0[:, None] + rng.uniform(-2, np.array(dims) + 1, (B, 60, 3))
           * cell).astype(np.float32)
    g = rng.normal(size=(B, 60, C)).astype(np.float32)

    def sample(gr):           # tdvnet/models/hypothesis.py:122, oct path
        q = (jnp.asarray(pts) - jnp.asarray(c0)[:, None]) / cell
        octs = jax.vmap(pack_trilinear_octs)(gr)
        return jax.vmap(trilinear_sample_octs, in_axes=(0, 0, None))(
            octs, q, dims)

    _, vjp = jax.vjp(sample, jnp.asarray(grid))
    (gj,) = vjp(jnp.asarray(g))
    g64 = t(grid).double().requires_grad_()
    out = trilinear_sample_ref(g64, t(pts), t(c0), cell)
    (ga,) = torch.autograd.grad(out, g64, t(g).double())
    gh = trilinear_sample_backward_ref(t(g), t(pts), t(c0), cell, grid.shape)
    assert _rel_l2(n(gh), n(ga)) < 1e-6                  # fp32 sums
    assert _rel_l2(n(gh), np.asarray(gj)) < 1e-6
    outside = ((pts - c0[:, None]) / cell < -1).any(-1) | \
        ((pts - c0[:, None]) / cell >= np.array(dims)).any(-1)
    assert outside.any() and not outside.all()
    # the differentiable per-scale entry runs the twin on the CPU
    gr = t(grid).requires_grad_()
    trilinear_sample_scale(gr, t(pts), t(c0), cell).backward(t(g))
    assert _rel_l2(n(gr.grad), n(gh)) < 1e-6
    with pytest.raises(NotImplementedError, match="tables"):
        from tdvnet_torch.models.hypothesis import sample_scales
        sample_scales([{"grid": gr, "stride": 1, "cell_offset": 1.0}],
                      t(pts), t(c0), cell)
    assert K.launch_counts()["trilinear_sample_backward"] == 0


# ------------------------------------------------------ the n_iters=1 step
@pytest.fixture(scope="module")
def refine_step():
    """One n_iters=1 train step of both packages from the same initial
    variables on the same batch at lambda 0.5 (the three offset passes of
    the default TrainConfig); the JAX package's gradients are read from its
    optimizer's first moment."""
    from tdvnet.models.threedvnet import ThreeDVNet as JNet
    from tdvnet.train import loop as JL
    from tdvnet_torch.config import tiny_test_config
    from tdvnet_torch.models.threedvnet import ThreeDVNet
    from tdvnet_torch.train import loop as TL
    from tdvnet_torch.weights import load_flax_into

    cfg_j = jax_tiny_config()
    cfg_t = tiny_test_config()
    jb, tb = both_batches(cfg_j, [0])
    model_j = JNet(cfg_j.model)
    variables = init_variables(model_j, jb, offsets=list(
        cfg_j.train.offsets), n_iters=1, lam=0.0, train=False, seed=3)
    state = JL.TrainState.create(
        apply_fn=model_j.apply, params=variables["params"],
        tx=JL.make_tx(cfg_j, variables["params"], 1),
        batch_stats=variables["batch_stats"])
    step_j = JL.make_train_step(model_j, cfg_j, 1, donate=False)
    new_j, mets_j = step_j(state, jb, jnp.float32(LAM))
    grads_j = adam_grads(new_j.opt_state, new_j.params)

    model = ThreeDVNet(cfg_t.model)
    load_flax_into(model, variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ts = TL.TrainState(model, TL.make_optimizer(cfg_t, model, 1))
    # oneDNN's fp32 convolution backward on the CPU is ~1e-3 off where a
    # train-mode BatchNorm's gradient sums cancel (tests/test_torch_train.py)
    with torch.backends.mkldnn.flags(enabled=False):
        ts, mets_t = TL.make_train_step(model, cfg_t, 1)(ts, tb, LAM)
    return dict(variables=variables, new_j=new_j, mets_j=mets_j,
                grads_j=grads_j, model=model, before=before, mets_t=mets_t,
                f64=_float64_rerun(cfg_t, variables, tb))


def _float64_rerun(cfg, variables, batch):
    """The port's step's loss and gradients in float64 from the same
    variables, through the twins, the geometry in fp32 as the fp32 run's
    (`chip_smoke.float64_twins`, the reference of chip_smoke.py's phase
    9b)."""
    import dataclasses

    import chip_smoke
    from tdvnet_torch.models.threedvnet import ThreeDVNet
    from tdvnet_torch.weights import load_flax_into

    model = ThreeDVNet(cfg.model)
    load_flax_into(model, variables)
    model = model.double().train()
    b = dataclasses.replace(batch, images=batch.images.double(),
                            depth_gt=batch.depth_gt.double())
    with torch.backends.mkldnn.flags(enabled=False), \
            chip_smoke.float64_twins():
        out = model(b, list(cfg.train.offsets), 1, LAM, with_metrics=False,
                    backbone_train=False)
        out["loss"].backward()
    return {"loss": float(out["loss"]), "loss_2d": float(out["loss_2d"]),
            "grads": {k: p.grad for k, p in model.named_parameters()
                      if p.grad is not None}}


def _jax_grads_as_torch(grads_j):
    from tdvnet_torch.weights import from_flax_variables

    return from_flax_variables({"params": jax.tree.map(
        lambda g: np.zeros(1, np.float32) if g is None else g, grads_j,
        is_leaf=lambda x: x is None)})


def test_refine_step_loss_matches_jax(refine_step):
    for k in ("loss", "loss_2d"):
        a, b = float(refine_step["mets_t"][k]), float(refine_step["mets_j"][k])
        assert abs(a - b) <= LOSS_RTOL * abs(b), (k, a, b)
    # the refinement passes carry weight: the loss is more than the 2D
    # stages' alone would give at lambda 0
    assert float(refine_step["mets_t"]["loss"]) > \
        float(refine_step["mets_t"]["loss_2d"])


def test_refine_step_gradients_match_jax(refine_step):
    grads_j = _jax_grads_as_torch(refine_step["grads_j"])
    model = refine_step["model"]
    frozen = {k for k, p in model.named_parameters() if not p.requires_grad}
    worst = {}
    for k, p in model.named_parameters():
        if k in frozen:
            assert p.grad is None
            continue
        want = n(grads_j[k])
        # a leaf no loss term reaches (the FPN's eighth-scale head) holds
        # exact zeros on both sides
        worst[k] = _rel_l2(n(p.grad), want) if np.any(want) \
            else float(np.abs(n(p.grad)).max())
    # the scene stages train at n_iters >= 1, every leaf of them
    for m in ("pointnet.", "scene_unet.", "decoder."):
        assert sum(k.startswith(m) for k in worst) >= 6, m
    for k in ZERO_GRAD:
        w = k.rsplit(".", 1)[0] + ".weight"
        scale = float(np.abs(n(grads_j[w])).max())
        assert float(model.get_parameter(k).grad.abs().max()) < 1e-4 * scale
        del worst[k]
    bad = {k: v for k, v in worst.items() if v > _grad_rtol(k)}
    assert not bad, bad


def test_refine_step_matches_its_float64_rerun(refine_step):
    f64, model = refine_step["f64"], refine_step["model"]
    for k in ("loss", "loss_2d"):
        a = float(refine_step["mets_t"][k])
        assert abs(a - f64[k]) <= LOSS_RTOL * abs(f64[k]), (k, a, f64[k])
    bad = {}
    for k, p in model.named_parameters():
        if p.grad is None or k in ZERO_GRAD:
            continue
        # a leaf no loss term reaches has no float64 gradient; the fp32
        # step's optimizer holds zeros there
        want = n(f64["grads"].get(k, torch.zeros_like(p.grad)))
        e = _rel_l2(n(p.grad), want) if np.any(want) \
            else float(np.abs(n(p.grad)).max())
        if e > (GRAD_RTOL_SCENE if k.startswith(SCENE) else GRAD_RTOL):
            bad[k] = e
    assert not bad, bad


def test_refine_step_params_and_batch_stats_match_jax(refine_step):
    from tdvnet_torch.weights import from_flax_variables

    new_j = refine_step["new_j"]
    want = from_flax_variables({
        "params": jax.tree.map(np.asarray, new_j.params),
        "batch_stats": jax.tree.map(np.asarray, new_j.batch_stats)})
    got = {k: v for k, v in refine_step["model"].state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert set(got) == set(want)
    # as in tests/test_torch_train.py: Adam's first step moves an element
    # whose gradient is rounding noise by up to lr in a direction the noise
    # picks; those elements move by at most lr, every other element and
    # every running statistic agrees within PARAM_ATOL. Noise here is
    # measured against each leaf's gradient tolerance, which JAX's one-pass
    # GroupNorm variance raises to GRAD_RTOL_SCENE for the scene leaves and
    # everything upstream of them: 4.9% of the trained elements (1% at
    # n_iters=0), at most NOISE_SHARE
    grads_j = _jax_grads_as_torch(refine_step["grads_j"])
    lr = 1e-3
    bad, n_noise, n_all = {}, 0, 0
    for k in got:
        d = (got[k] - want[k]).abs()
        if k in grads_j and grads_j[k].numel() == d.numel() \
                and grads_j[k].any():
            g = grads_j[k].abs()
            noise = ((g <= _grad_rtol(k) * g.max()) & (g > 0)) \
                | (k in ZERO_GRAD)
            n_noise += int(noise.sum())
            n_all += d.numel()
            assert float((got[k] - refine_step["before"][k]).abs().max()) \
                <= lr + 1e-6, k
            d = torch.where(noise, torch.zeros_like(d), d)
        if float(d.max()) > PARAM_ATOL:
            bad[k] = float(d.max())
    assert not bad, bad
    assert n_noise <= NOISE_SHARE * n_all, (n_noise, n_all)
    # the decoder's train-mode BatchNorms moved their running statistics
    for i in range(3):
        k = f"decoder.BatchNorm_{i}.running_var"
        assert not torch.equal(got[k], refine_step["before"][k]), k
