"""Each ported module against its flax counterpart at the tiny config, with
random flax parameters (norm statistics and affines perturbed off their
init values) carried over by `weights.from_flax_variables`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import (both_batches, flax_apply, flax_variables,
                            jax_tiny_config, n, t, torch_module)
from _torch_helpers import torch_one_thread  # noqa: F401 (autouse)


def sub(vs, name):
    return {c: tree[name] for c, tree in vs.items() if name in tree}


@pytest.fixture(scope="module")
def mvs():
    from tdvnet.models.mvsnet import MVSNet as J

    cfg = jax_tiny_config()
    c, dc = cfg.model, cfg.model.depth_test
    jb, tb = both_batches(cfg, [1])
    net = J(c.feat_dim, c.img_size, c.cost_base_channels, warp_mode="gather")
    cams = (jb.rotmats, jb.tvecs, jb.K, jb.ref_idx, jb.src_idx, jb.src_mask,
            dc.depth_start, dc.depth_interval, dc.n_intervals, dc.size)
    vs = flax_variables(net, jb.images, *cams)
    return cfg, jb, tb, net, vs, cams


def test_backbone_and_fpn_match_flax(mvs):
    from tdvnet.models.mvsnet import MVSNet as J
    from tdvnet_torch.models.backbone import MnasMulti
    from tdvnet_torch.models.fpn import FPN

    cfg, jb, tb, net, vs, _ = mvs
    bb = torch_module(MnasMulti(), sub(vs, "backbone"))
    fpn = torch_module(FPN(cfg.model.feat_dim), sub(vs, "fpn"))
    a = flax_apply(net, vs, jb.images, method=J.extract_features)
    with torch.no_grad():
        c = bb(tb.images.permute(0, 3, 1, 2))
        b = fpn(c)
    assert [tuple(x.shape[2:]) for x in c] == [(32, 40), (16, 20), (8, 10),
                                               (4, 5), (2, 3)]
    for x, y in zip(a, b[:3]):
        # fp32 convolutions summed in another order, through 17 BN layers
        np.testing.assert_allclose(np.asarray(x), n(y.permute(0, 2, 3, 1)),
                                   rtol=1e-4, atol=1e-4)


def test_cost_reg_and_predict_depth_match_flax(mvs):
    from tdvnet.models.mvsnet import MVSNet as J
    from tdvnet_torch.models.mvsnet import MVSNet as T

    cfg, jb, tb, net, vs, cams = mvs
    c = cfg.model
    tnet = torch_module(T(c.feat_dim, c.img_size, c.cost_base_channels), vs)
    # teacher forcing: both sides get the JAX quarter features
    _, quarter, _ = flax_apply(net, vs, jb.images,
                               method=J.extract_features)
    depth_j, _ = flax_apply(net, vs, quarter, *cams, method=J.predict_depth)
    with torch.no_grad():
        depth_t = tnet.predict_depth(t(quarter), tb.rotmats, tb.tvecs, tb.K,
                                     tb.ref_idx, tb.src_idx, tb.src_mask,
                                     *cams[6:])
    # depths of ~1 m after 3D convs and a 16-plane soft-argmax in fp32
    np.testing.assert_allclose(np.asarray(depth_j), n(depth_t), rtol=1e-5,
                               atol=1e-5)


def _points(rng, n_pts, n_scenes):
    pts = rng.uniform(-0.3, 1.6, (n_pts, 3)).astype(np.float32)
    scene = np.sort(rng.integers(0, n_scenes, n_pts)).astype(np.int32)
    valid = rng.uniform(size=n_pts) > 0.1
    return pts, scene, valid


@pytest.mark.parametrize("max_anchors", [4096, 60])
def test_voxelize_matches_jax_exactly(max_anchors):
    from tdvnet.ops import voxelize as J
    from tdvnet_torch.ops import voxelize as T

    rng = np.random.default_rng(11)
    pts, scene, valid = _points(rng, 3000, 2)
    # the 16^3 grid of 0.08 m covers 1.28 m: some points fall outside
    a = J.voxelize(pts, scene, valid, 0.08, (16, 16, 16), max_anchors, 2)
    b = T.voxelize(t(pts), t(scene), torch.from_numpy(valid), 0.08,
                   (16, 16, 16), max_anchors, 2)
    for f in a._fields:
        x, y = np.asarray(getattr(a, f)), n(getattr(b, f))
        if np.issubdtype(x.dtype, np.floating):
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(x, y, err_msg=f)
    assert int(b.n_out_of_grid) > 0
    assert (int(b.n_overflow) > 0) == (max_anchors < 1000)
    feats = rng.normal(size=(max_anchors, 5)).astype(np.float32)
    da, oa = J.scatter_anchors_to_dense(feats, a, (16, 16, 16), 2)
    db, ob = T.scatter_anchors_to_dense(t(feats), b, (16, 16, 16), 2)
    np.testing.assert_array_equal(np.asarray(da), n(db))
    np.testing.assert_array_equal(np.asarray(oa), n(ob))


def test_pointnet_matches_flax():
    from tdvnet.models.pointnet import PointNet as J
    from tdvnet.ops.voxelize import voxelize
    from tdvnet_torch.models.pointnet import PointNet as T

    rng = np.random.default_rng(12)
    pts, scene, valid = _points(rng, 1500, 2)
    vg = voxelize(pts, scene, valid, 0.08, (16, 16, 16), 400, 2)
    order = np.asarray(vg.order)
    x = rng.normal(size=(1500, 11)).astype(np.float32)[order]
    p2a, pv = vg.p2a_sorted, np.asarray(vg.point_valid)[order]
    net = J(32, 16)
    vs = flax_variables(net, x, p2a, pv, 400)
    a = flax_apply(net, vs, x, p2a, pv, 400, indices_are_sorted=True)
    tnet = torch_module(T(11, 32, 16), vs)
    with torch.no_grad():
        b = tnet(t(x), t(p2a), torch.from_numpy(pv), 400)
    # 6 fp32 dense layers of width <= 64 with max pools between them
    np.testing.assert_allclose(np.asarray(a), n(b), rtol=1e-5, atol=1e-5)
    assert (n(b) != 0).any(axis=1).sum() > 100


def test_masked_group_norm_counts_each_batch_element_alone():
    from tdvnet.models.layers import masked_group_norm as J
    from tdvnet_torch.models.layers import masked_group_norm as T

    rng = np.random.default_rng(13)
    x = rng.normal(1, 2, (2, 6, 6, 6, 12)).astype(np.float32)
    mask = np.zeros((2, 6, 6, 6, 1), np.float32)
    mask[0] = rng.uniform(size=(6, 6, 6, 1)) > 0.3
    mask[1] = rng.uniform(size=(6, 6, 6, 1)) > 0.9   # far fewer sites
    scale = rng.normal(size=12).astype(np.float32)
    bias = rng.normal(size=12).astype(np.float32)
    a = J(x, mask, 4, scale, bias)
    b = T(t(x).permute(0, 4, 1, 2, 3), t(mask).permute(0, 4, 1, 2, 3), 4,
          t(scale), t(bias))
    # fp32 group statistics over a few hundred sites
    np.testing.assert_allclose(np.asarray(a), n(b.permute(0, 2, 3, 4, 1)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("grid", [(16, 16, 16), (8, 12, 16)])
def test_scene_unet_matches_flax(grid):
    from tdvnet.models.scene_unet import SceneUNet as J
    from tdvnet_torch.models.scene_unet import SceneUNet as T

    c = jax_tiny_config().model
    rng = np.random.default_rng(14)
    x = rng.normal(size=(2, *grid, c.unet_dims[0])).astype(np.float32)
    mask = (rng.uniform(size=(2, *grid, 1)) > 0.7).astype(np.float32)
    net = J(c.unet_dims, c.unet_groups, (1, 2, 1))
    vs = flax_variables(net, x, mask)
    a = flax_apply(net, vs, x, mask)
    tnet = torch_module(T(c.unet_dims, c.unet_groups, (1, 2, 1)), vs)
    with torch.no_grad():
        b = tnet(t(x), t(mask))
    assert [s["stride"] for s in b] == [4, 2, 1]
    for sa, sb in zip(a, b):
        assert sa["stride"] == sb["stride"]
        np.testing.assert_array_equal(np.asarray(sa["mask"]), n(sb["mask"]))
        # ~20 fp32 conv + masked-GN layers (the stride-2 convs pad (0, 1))
        np.testing.assert_allclose(np.asarray(sa["grid"]), n(sb["grid"]),
                                   rtol=1e-4, atol=1e-4)


def test_hypothesis_decoder_matches_flax():
    from tdvnet.models.hypothesis import HypothesisDecoder as J
    from tdvnet_torch.models.hypothesis import HypothesisDecoder as T

    rng = np.random.default_rng(15)
    feats = rng.normal(size=(300, 7, 72)).astype(np.float32)
    net = J(16, 3)
    vs = flax_variables(net, feats)
    a = flax_apply(net, vs, feats)
    tnet = torch_module(T(72, 16, 3), vs)
    with torch.no_grad():
        b = tnet(t(feats))
    # softmax scores after 4 fp32 convs along the hypothesis axis
    np.testing.assert_allclose(np.asarray(a), n(b), rtol=1e-5, atol=1e-6)


def test_propagation_net_matches_flax():
    from tdvnet.models.upsampling import PropagationNet as J
    from tdvnet_torch.models.upsampling import PropagationNet as T

    rng = np.random.default_rng(16)
    guide = rng.normal(size=(3, 12, 14, 8)).astype(np.float32)
    depth = rng.uniform(0.5, 4, (3, 12, 14)).astype(np.float32)
    net = J(8)
    vs = flax_variables(net, guide, depth)
    a = flax_apply(net, vs, guide, depth)
    tnet = torch_module(T(8, 8), vs)
    with torch.no_grad():
        b = tnet(t(guide), t(depth))
    # a convex blend of depths ~2 m; logits after 4 fp32 conv-BN-ReLU
    np.testing.assert_allclose(np.asarray(a), n(b), rtol=1e-5, atol=1e-5)


def test_weight_bridge_layout_rules():
    from tdvnet_torch.weights import from_flax_variables

    rng = np.random.default_rng(17)
    k = rng.normal(size=(3, 3, 3, 4, 5)).astype(np.float32)
    sd = from_flax_variables({
        "params": {"a": {"Conv_0": {"kernel": k}},
                   "MaskedUpConv3d_0": {"Conv_0": {"kernel": k}},
                   "d": {"kernel": k[0, 0, 0]}, "BatchNorm_0": {
                       "scale": k[0, 0, 0, 0], "bias": k[0, 0, 0, 1]}},
        "batch_stats": {"BatchNorm_0": {"mean": k[0, 0, 0, 2],
                                        "var": k[0, 0, 0, 3]}}})
    np.testing.assert_array_equal(n(sd["a.Conv_0.weight"]),
                                  k.transpose(4, 3, 0, 1, 2))
    np.testing.assert_array_equal(n(sd["MaskedUpConv3d_0.Conv_0.weight"]),
                                  k[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2))
    np.testing.assert_array_equal(n(sd["d.weight"]), k[0, 0, 0].T)
    assert set(sd) == {"a.Conv_0.weight", "MaskedUpConv3d_0.Conv_0.weight",
                       "d.weight", "BatchNorm_0.weight", "BatchNorm_0.bias",
                       "BatchNorm_0.running_mean", "BatchNorm_0.running_var"}
    # the up-conv rule makes ConvTranspose3d equal the flax input-dilated conv
    from flax import linen as nn
    from tdvnet_torch.models.layers import up_conv3d

    x = rng.normal(size=(1, 4, 5, 6, 4)).astype(np.float32)
    conv = nn.Conv(5, (3, 3, 3), input_dilation=(2, 2, 2),
                   padding=((1, 2),) * 3, use_bias=False)
    a = conv.apply({"params": {"kernel": jnp.asarray(k)}}, x)
    m = up_conv3d(4, 5)
    m.weight.data = sd["MaskedUpConv3d_0.Conv_0.weight"]
    with torch.no_grad():
        b = m(t(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    np.testing.assert_allclose(np.asarray(a), n(b), rtol=1e-5, atol=1e-5)
    assert jax.devices()[0].platform == "cpu"


@pytest.mark.parametrize("shape,co", [((2, 4, 3, 5, 4), 3), ((1, 6, 4, 4, 4), 5),
                                      ((1, 3, 1, 2, 1), 2)])
def test_up_conv_is_the_transposed_conv(shape, co):
    """The up-conv's polyphase forward and its backward equal
    `conv_transpose3d(stride=2, padding=1, output_padding=1)` in float64,
    and its fp32 forward repeats bit for bit."""
    import torch.nn.functional as F

    from tdvnet_torch.models.layers import up_conv3d

    g = torch.Generator().manual_seed(0)
    m = up_conv3d(shape[1], co).double()
    x = torch.randn(*shape, generator=g, dtype=torch.float64,
                    requires_grad=True)
    y = m(x)
    gy = torch.randn(y.shape, generator=g, dtype=torch.float64)
    y.backward(gy)
    x2 = x.detach().clone().requires_grad_()
    w2 = m.weight.detach().clone().requires_grad_()
    y2 = F.conv_transpose3d(x2, w2, stride=2, padding=1, output_padding=1)
    y2.backward(gy)
    assert y.shape == y2.shape == (shape[0], co, *(2 * s for s in shape[2:]))
    torch.testing.assert_close(y, y2, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(x.grad, x2.grad, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(m.weight.grad, w2.grad, rtol=1e-12, atol=1e-12)
    m32 = m.float()
    with torch.no_grad():
        a, b = m32(x.detach().float()), m32(x.detach().float())
    assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(5, 4, 7), (3, 4, 6, 6, 6), (2, 3, 9, 9)])
def test_train_mode_batch_norm_is_torch_batch_norm_on_the_cpu(shape):
    """Train-mode BatchNorm takes torch's native kernel (never cuDNN's on
    the card); on the CPU that is `F.batch_norm`, output and gradients bit
    for bit, and the running statistics follow flax's rule."""
    import torch.nn.functional as F

    from tdvnet_torch.models.layers import batch_norm

    g = torch.Generator().manual_seed(1)
    bn = batch_norm(len(shape) - 2, shape[1])
    with torch.no_grad():
        bn.weight.copy_(torch.randn(shape[1], generator=g))
        bn.bias.copy_(torch.randn(shape[1], generator=g))
    bn.train()
    x = torch.randn(*shape, generator=g, requires_grad=True)
    y = bn(x)
    gy = torch.randn(y.shape, generator=g)
    got = torch.autograd.grad(y, (x, bn.weight, bn.bias), gy)
    x2 = x.detach().clone().requires_grad_()
    y2 = F.batch_norm(x2, None, None, bn.weight, bn.bias, True, 0.0, bn.eps)
    want = torch.autograd.grad(y2, (x2, bn.weight, bn.bias), gy)
    assert torch.equal(y, y2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    dims = [0, *range(2, len(shape))]
    var, mean = torch.var_mean(x.detach(), dim=dims, unbiased=False)
    torch.testing.assert_close(bn.running_mean, bn.momentum * mean)
    torch.testing.assert_close(bn.running_var,
                               (1 - bn.momentum) + bn.momentum * var)
