"""The port's training step against the JAX package's, on the CPU.

The three hand backward twins (source variance, soft-argmax, propagation
blend) against `torch.autograd` of their forward twins and against
`jax.vjp` of the JAX functions; one tiny-config n_iters=0 step of
`tdvnet_torch.train.loop.make_train_step` against
`tdvnet.train.loop.make_train_step` from the same weights on the same batch
(loss, every gradient, the parameters after Adam, the BatchNorm running
statistics); the schedules, the loader's order, `fit`, and the `.npz`
export read back by the JAX package. The backward kernels themselves are
held to these twins on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import (adam_grads as _adam_grads, both_batches,
                            init_variables as _init_variables,
                            jax_tiny_config, n, t)
from _torch_helpers import torch_one_thread  # noqa: F401 (autouse)

# relative L2 of a gradient leaf (fp32 sums in another order on each side)
GRAD_RTOL = 1e-4
# refine_full's gradients in the JAX package's fp32 are ~1.5e-3 off a
# float64 rerun of the same PropagationNet on the same inputs, where the
# port's fp32 are 1e-5 off (its train-mode BatchNorm statistics and their
# gradients sum over 15360 elements per channel; flax computes the
# variance in one pass, E[x^2] - E[x]^2)
GRAD_RTOL_REFINE_FULL = 3e-3
# the last cost conv's bias shifts every plane's cost alike, which the
# soft-argmax does not see: its gradient is zero in exact arithmetic
ZERO_GRAD = "mvsnet.cost_reg.Conv_0.bias"


def _grad_rtol(key):
    return GRAD_RTOL_REFINE_FULL if key.startswith("refine_full.") \
        else GRAD_RTOL
# relative error of a loss, and the absolute error of a parameter after one
# Adam step or of a running statistic
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ------------------------------------------------------------ backward twins
@pytest.fixture(scope="module")
def variance_case():
    """Points of a tiny batch's refs around its cameras (in view, out of
    view, on the border), unit features, and a mask that drops one source
    of refs 1 and 2."""
    cfg = jax_tiny_config()
    jb, tb = both_batches(cfg, [0])
    rng = np.random.default_rng(11)
    feats = rng.normal(size=(jb.n_imgs, 16, 20, 8)).astype(np.float32)
    mask = np.asarray(jb.src_mask).copy()
    mask[1:, 2] = False
    pts = (rng.normal(0, 1.0, (3, 300, 3))
           + np.array([0.0, 0.0, 2.5])).astype(np.float32)
    g = rng.normal(size=(3, 300, 8)).astype(np.float32)
    return cfg, jb, tb, feats, mask, pts, g


def test_source_variance_backward_ref_matches_autograd_and_jax(variance_case):
    from tdvnet.ops import camera as JC, costvolume as J
    from tdvnet_torch.kernels.variance import (source_variance_backward_ref,
                                               source_variance_ref)
    from tdvnet_torch.ops import camera as TC

    cfg, jb, tb, feats, mask, pts, g = variance_case
    img = cfg.model.img_size
    P_j = JC.projection_matrix(jb.K, jb.rotmats, jb.tvecs)

    def f(fe):
        return J._source_variance(jnp.asarray(pts), fe, jb.src_idx,
                                  jnp.asarray(mask), P_j, img)

    (var_j, mean_j), vjp = jax.vjp(f, jnp.asarray(feats))
    (gj,) = vjp((jnp.asarray(g), jnp.zeros_like(mean_j)))

    P_t = TC.projection_matrix(tb.K, tb.rotmats, tb.tvecs)
    feats_t = t(feats).requires_grad_()
    args = (t(pts), feats_t, tb.src_idx, t(mask), P_t, img)
    var_t, mean_t = source_variance_ref(*args, with_mean=True)
    (ga,) = torch.autograd.grad(var_t, feats_t, t(g))
    gh = source_variance_backward_ref(t(g), mean_t.detach(), t(pts),
                                      t(feats), tb.src_idx, t(mask), P_t,
                                      img)
    assert gh.shape == feats.shape and float(gh.abs().sum()) > 0
    np.testing.assert_allclose(n(mean_t), np.asarray(mean_j), rtol=1e-4,
                               atol=2e-5)
    assert _rel_l2(n(gh), n(ga)) < 1e-5
    assert _rel_l2(n(gh), np.asarray(gj)) < GRAD_RTOL


def test_source_variance_wrapper_differentiates_feats_only(variance_case):
    from tdvnet_torch import kernels as K
    from tdvnet_torch.kernels.variance import source_variance_ref
    from tdvnet_torch.ops import camera as TC

    cfg, jb, tb, feats, mask, pts, g = variance_case
    img = cfg.model.img_size
    P_t = TC.projection_matrix(tb.K, tb.rotmats, tb.tvecs)
    f1, f2 = t(feats).requires_grad_(), t(feats).requires_grad_()
    K.reset_launch_counts()
    plane = (1, pts.shape[1])
    K.source_variance(t(pts), f1, tb.src_idx, t(mask), P_t, img,
                      plane).backward(t(g))
    source_variance_ref(t(pts), f2, tb.src_idx, t(mask), P_t, img).backward(
        t(g))
    assert _rel_l2(n(f1.grad), n(f2.grad)) < 1e-5
    # the CPU runs the twins and counts no launch
    assert all(v == 0 for v in K.launch_counts().values())
    with pytest.raises(NotImplementedError, match="points"):
        K.source_variance(t(pts).requires_grad_(), t(feats), tb.src_idx,
                          t(mask), P_t, img, plane)
    with torch.no_grad():
        K.source_variance(t(pts).requires_grad_(), f1, tb.src_idx, t(mask),
                          P_t, img, plane)


def test_softargmax_backward_ref_matches_autograd_and_jax():
    from tdvnet_torch import kernels as K
    from tdvnet_torch.kernels.softargmax import (
        softargmax_depth_backward_ref, softargmax_depth_ref)

    rng = np.random.default_rng(12)
    cost = (rng.normal(size=(3, 16, 5, 7)) * 3).astype(np.float32)
    dv = np.linspace(0.5, 1.25, 16).astype(np.float32)
    g = rng.normal(size=(3, 5, 7)).astype(np.float32)

    def tail(c):           # tdvnet/models/mvsnet.py:89-93
        prob = jax.nn.softmax(-c, axis=1)
        return jnp.sum(prob * dv[None, :, None, None], axis=1)

    _, vjp = jax.vjp(tail, jnp.asarray(cost))
    (gj,) = vjp(jnp.asarray(g))
    c = t(cost).requires_grad_()
    depth = softargmax_depth_ref(c, t(dv))
    (ga,) = torch.autograd.grad(depth, c, t(g))
    gh = softargmax_depth_backward_ref(t(g), t(cost), t(dv), depth.detach())
    assert _rel_l2(n(gh), n(ga)) < 1e-5
    assert _rel_l2(n(gh), np.asarray(gj)) < GRAD_RTOL
    c2 = t(cost).requires_grad_()
    K.softargmax_depth(c2, t(dv)).backward(t(g))
    assert _rel_l2(n(c2.grad), n(ga)) < 1e-5


@pytest.mark.parametrize("hw", [(6, 7), (1, 5), (2, 1)])
def test_propagation_backward_ref_matches_autograd_and_jax(hw):
    from tdvnet.models.upsampling import unfold3x3 as j_unfold
    from tdvnet_torch import kernels as K
    from tdvnet_torch.kernels.propagation import (
        propagation_blend_backward_ref, propagation_blend_ref)

    H, W = hw
    rng = np.random.default_rng(13)
    logits = rng.normal(size=(2, 9, H, W)).astype(np.float32)
    depth = rng.uniform(1, 4, (2, H, W)).astype(np.float32)
    g = rng.normal(size=(2, H, W)).astype(np.float32)

    def tail(lg, d):       # tdvnet/models/upsampling.py:44-45
        w = jax.nn.softmax(lg, axis=-1)
        return jnp.sum(w * j_unfold(d), axis=-1)

    lj = jnp.asarray(logits.transpose(0, 2, 3, 1))
    _, vjp = jax.vjp(tail, lj, jnp.asarray(depth))
    gl_j, gd_j = vjp(jnp.asarray(g))

    # the logits as the permuted view of an NCHW tensor, as PropagationNet
    # hands them over
    lt = t(logits).requires_grad_()
    dt = t(depth).requires_grad_()
    out = propagation_blend_ref(lt.permute(0, 2, 3, 1), dt)
    gl_a, gd_a = torch.autograd.grad(out, (lt, dt), t(g))
    gl_h, gd_h = propagation_blend_backward_ref(
        t(g), t(logits).permute(0, 2, 3, 1), t(depth), out.detach())
    assert _rel_l2(n(gl_h), n(gl_a.permute(0, 2, 3, 1))) < 1e-5
    assert _rel_l2(n(gd_h), n(gd_a)) < 1e-5
    assert _rel_l2(n(gl_h), np.asarray(gl_j)) < GRAD_RTOL
    assert _rel_l2(n(gd_h), np.asarray(gd_j)) < GRAD_RTOL
    lt2, dt2 = t(logits).requires_grad_(), t(depth).requires_grad_()
    K.propagation_blend(lt2.permute(0, 2, 3, 1), dt2).backward(t(g))
    assert _rel_l2(n(lt2.grad), n(gl_a)) < 1e-5
    assert _rel_l2(n(dt2.grad), n(gd_a)) < 1e-5


# ------------------------------------------------------------ the train step
@pytest.fixture(scope="module")
def one_step():
    """One n_iters=0 train step of both packages from the same initial
    variables on the same batch; the JAX package's gradients are read from
    its optimizer's first moment."""
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
    variables = _init_variables(model_j, jb, offsets=list(
        cfg_j.train.offsets), n_iters=1, lam=0.0, train=False)
    state = JL.TrainState.create(
        apply_fn=model_j.apply, params=variables["params"],
        tx=JL.make_tx(cfg_j, variables["params"], 1),
        batch_stats=variables["batch_stats"])
    lam = 0.5
    step_j = JL.make_train_step(model_j, cfg_j, 0, donate=False)
    new_j, mets_j = step_j(state, jb, jnp.float32(lam))
    grads_j = _adam_grads(new_j.opt_state, new_j.params)

    model = ThreeDVNet(cfg_t.model)
    load_flax_into(model, variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ts = TL.TrainState(model, TL.make_optimizer(cfg_t, model, 1))
    # oneDNN's fp32 convolution backward on the CPU is off by ~1e-3 where a
    # train-mode BatchNorm's gradient sums cancel (its float64 rerun agrees
    # with JAX's fp32 to 1e-6); torch's own CPU convolutions are not
    with torch.backends.mkldnn.flags(enabled=False):
        ts, mets_t = TL.make_train_step(model, cfg_t, 0)(ts, tb, lam)
    return dict(variables=variables, new_j=new_j, mets_j=mets_j,
                grads_j=grads_j, model=model, before=before, mets_t=mets_t)


def test_train_step_loss_matches_jax(one_step):
    for k in ("loss", "loss_2d"):
        a, b = float(one_step["mets_t"][k]), float(one_step["mets_j"][k])
        assert abs(a - b) <= LOSS_RTOL * abs(b), (k, a, b)


def test_train_step_gradients_match_jax(one_step):
    from tdvnet_torch.weights import from_flax_variables

    grads_j = from_flax_variables({"params": jax.tree.map(
        lambda g: np.zeros(1, np.float32) if g is None else g,
        one_step["grads_j"], is_leaf=lambda x: x is None)})
    model = one_step["model"]
    trained = {k for k, p in model.named_parameters() if p.requires_grad}
    frozen = {k for k, p in model.named_parameters() if not p.requires_grad}
    # the frozen leaves are the backbone's BatchNorm scales and biases, as
    # the JAX package's optimizer labels them
    assert frozen and all(k.startswith("mvsnet.backbone.") and "BatchNorm"
                          in k for k in frozen)
    assert set(grads_j) == trained | frozen
    worst = {}
    for k, p in model.named_parameters():
        if k in frozen:
            assert p.grad is None
            continue
        want = n(grads_j[k])
        worst[k] = _rel_l2(n(p.grad), want) if np.any(want) \
            else float(np.abs(n(p.grad)).max())
    # n_iters=0: the scene stages take no gradient on either side
    for k, v in worst.items():
        if k.startswith(("pointnet.", "scene_unet.", "decoder.")):
            assert v == 0.0, k
    # ZERO_GRAD: both sides hold rounding noise far under the weight's
    scale = float(np.abs(n(grads_j["mvsnet.cost_reg.Conv_0.weight"])).max())
    assert float(np.abs(n(grads_j[ZERO_GRAD])).max()) < 1e-4 * scale
    assert float(model.get_parameter(ZERO_GRAD).grad.abs().max()) \
        < 1e-4 * scale
    del worst[ZERO_GRAD]
    bad = {k: v for k, v in worst.items() if v > _grad_rtol(k)}
    assert not bad, bad


def test_train_step_params_and_batch_stats_match_jax(one_step):
    from tdvnet_torch.weights import from_flax_variables

    new_j = one_step["new_j"]
    want = from_flax_variables({
        "params": jax.tree.map(np.asarray, new_j.params),
        "batch_stats": jax.tree.map(np.asarray, new_j.batch_stats)})
    got = {k: v for k, v in one_step["model"].state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert set(got) == set(want)
    # Adam's first step moves an element by lr * g / (|g| + eps): a gradient
    # within rounding noise of zero (|g| under its leaf's gradient tolerance
    # times the leaf's largest |g|, or ZERO_GRAD) moves it by up to lr in a
    # direction the noise picks. Those elements (about 1% of the trained
    # ones here) move by at most lr; every other element and every running
    # statistic agrees within PARAM_ATOL.
    grads_j = from_flax_variables({"params": jax.tree.map(
        lambda g: np.zeros(1, np.float32) if g is None else g,
        one_step["grads_j"], is_leaf=lambda x: x is None)})
    lr = 1e-3
    bad, n_noise, n_all = {}, 0, 0
    for k in got:
        d = (got[k] - want[k]).abs()
        if k in grads_j and grads_j[k].numel() == d.numel() \
                and grads_j[k].any():
            g = grads_j[k].abs()
            # exact zeros (dead channels) are no noise: both sides keep them
            noise = ((g <= _grad_rtol(k) * g.max()) & (g > 0)) \
                | (k == ZERO_GRAD)
            n_noise += int(noise.sum())
            n_all += d.numel()
            assert float((got[k] - one_step["before"][k]).abs().max()) \
                <= lr + 1e-6, k
            d = torch.where(noise, torch.zeros_like(d), d)
        if float(d.max()) > PARAM_ATOL:
            bad[k] = float(d.max())
    assert not bad, bad
    assert n_noise <= 0.02 * n_all, (n_noise, n_all)
    # the running variance averages the biased batch variance (flax's
    # rule): torch's unbiased one would be off by var / (n - 1) * 0.1
    cr = "mvsnet.cost_reg.ConvBnRelu_0.BatchNorm_0.running_var"
    assert not torch.equal(got[cr], one_step["before"][cr])


def test_train_step_keeps_backbone_batchnorm_frozen(one_step):
    model, before = one_step["model"], one_step["before"]
    bn = [k for k in before if k.startswith("mvsnet.backbone.")
          and "BatchNorm" in k]
    assert bn
    for k in bn:
        assert torch.equal(model.state_dict()[k], before[k]), k
    moved = [k for k in before if k.startswith("mvsnet.cost_reg.")
             and k.endswith("running_mean")]
    assert all(not torch.equal(model.state_dict()[k], before[k])
               for k in moved)


# ------------------------------------------------- schedules, loader, fit
def test_schedules_match_jax():
    import dataclasses

    from tdvnet.config import tiny_test_config as j_tiny
    from tdvnet.models.threedvnet import ThreeDVNet as JNet
    from tdvnet.train import loop as JL
    from tdvnet_torch.config import tiny_test_config
    from tdvnet_torch.train import loop as TL

    for finetune in (False, True):
        cj, ct = j_tiny(), tiny_test_config()
        cj = dataclasses.replace(cj, train=dataclasses.replace(
            cj.train, finetune=finetune))
        ct = dataclasses.replace(ct, train=dataclasses.replace(
            ct.train, finetune=finetune))
        for epoch in range(151):
            assert TL.lambda_for_epoch(ct, epoch) == \
                JL.lambda_for_epoch(cj, epoch)
            assert TL.n_iters_for_epoch(ct, epoch) == \
                JL.n_iters_for_epoch(cj, epoch)
    for args in ((1e-3, 100, 0.1, 7, 0), (1e-4, 50, 0.5, 3, 21)):
        sj, st = JL.make_lr_schedule(*args), TL.make_lr_schedule(*args)
        assert all(st(s) == sj(s) for s in range(0, 151 * args[3]))


def test_train_config_refuses_what_the_port_lacks():
    """The three knobs of the JAX package's TrainConfig construct (the port
    has them); a microbatch count below 1, or not whole, is refused."""
    from tdvnet_torch.config import TrainConfig

    for kw in ({"bf16_compute": True}, {"remat": True},
               {"grad_accum_steps": 2}):
        cfg = TrainConfig(**kw)
        assert all(getattr(cfg, k) == v for k, v in kw.items())
    for k in (0, -1, 1.5):
        with pytest.raises(ValueError):
            TrainConfig(grad_accum_steps=k)


def test_model_config_refuses_a_dtype_the_port_lacks():
    """JAX's eval CLI sets `ModelConfig.dtype` to bf16 for `--bf16`, which
    the port takes (bf16 inference); it computes in no other dtype than
    those two, so it refuses fp16 and fp64 rather than ignore them."""
    import dataclasses

    from tdvnet_torch.config import ModelConfig, tiny_test_config

    for dtype in (torch.float16, torch.float64):
        with pytest.raises(NotImplementedError, match="dtype"):
            ModelConfig(dtype=dtype)
        with pytest.raises(NotImplementedError, match="dtype"):
            dataclasses.replace(tiny_test_config().model, dtype=dtype)
    for dtype in (torch.float32, torch.bfloat16):
        assert ModelConfig(dtype=dtype).dtype == dtype
        assert dataclasses.replace(tiny_test_config().model,
                                   dtype=dtype).dtype == dtype


def _datasets(root, n_scenes, hw, n_ref):
    from tdvnet.data.dataset import Dataset as JD
    from tdvnet.data.frameselector import EveryNthSelector as JS
    from tdvnet_torch.data.dataset import Dataset as TD
    from tdvnet_torch.data.frameselector import EveryNthSelector as TS
    from tdvnet_torch.data.synthetic_dataset import make_scene_dir

    dirs = [make_scene_dir(root, f"s{i}", 6, hw, i, device="cpu")
            for i in range(n_scenes)]
    kw = dict(depth_img_size=hw, img_size=hw, augment=False,
              n_src_on_either_side=1)
    return (JD(dirs, JS(1), n_ref, **kw), TD(dirs, TS(1), n_ref, **kw))


def test_streaming_loader_order_matches_jax(tmp_path):
    from tdvnet.train.loader import StreamingLoader as JLoader
    from tdvnet_torch.train.loader import StreamingLoader as TLoader

    dj, dt = _datasets(str(tmp_path), 5, (32, 40), 3)
    lj = JLoader(dj, n_scenes=2, n_views=5, n_ref=3, seed=1, prefetch=2,
                 workers=2)
    lt = TLoader(dt, n_scenes=2, n_views=5, n_ref=3, seed=1, prefetch=2,
                 workers=2)
    assert len(lt) == len(lj) == 2
    for e in range(3):
        assert [list(g) for g in lt.epoch_groups(e)] == \
            [list(g) for g in lj._epoch_groups(e)]
    for bj, bt in zip(lj.epoch(1), lt.epoch(1)):
        np.testing.assert_array_equal(np.asarray(bj.images), n(bt.images))
        np.testing.assert_array_equal(np.asarray(bj.depth_gt),
                                      n(bt.depth_gt))


def test_fit_writes_log_checkpoint_and_npz_that_jax_loads(tmp_path):
    import json

    from tdvnet.train.checkpoints import load_npz as j_load_npz
    from tdvnet_torch.config import tiny_test_config
    from tdvnet_torch.data import batch as B, synthetic
    from tdvnet_torch.train import checkpoints as C, loop as TL
    from tdvnet_torch.weights import from_flax_variables, load_npz

    cfg = tiny_test_config()
    bc = cfg.batch
    batches = [B.collate_scenes(
        [synthetic.make_batch_scene(bc.n_views, bc.img_size,
                                    bc.depth_img_size, seed=s)],
        bc.n_views, bc.n_ref, bc.n_src_on_either_side) for s in (0, 1)]
    import dataclasses
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, n_iters_early=0, log_every=1, use_tensorboard=False))
    npz = str(tmp_path / "w.npz")
    model, state = TL.fit(cfg, batches, lambda: batches[:1], n_epochs=2,
                          log_dir=str(tmp_path / "runs"),
                          ckpt_dir=str(tmp_path / "ckpt"), export_npz=npz,
                          export_every=2, device="cpu")
    with open(tmp_path / "runs" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    train = [r for r in recs if "train/loss" in r]
    assert [r["step"] for r in train] == [0, 1, 2, 3]
    assert all(np.isfinite(r["train/loss"]) for r in train)
    assert sum("val/loss" in r for r in recs) == 2
    assert C.latest_epoch(str(tmp_path / "ckpt")) == 2
    assert state.optimizer.count == 4

    # the export loads in the JAX package with the same leaves
    vj, ej = j_load_npz(npz)
    vt, et = load_npz(npz)
    assert ej == et == 2
    fj, ft = from_flax_variables(vj), from_flax_variables(vt)
    assert set(fj) == set(ft) == {k for k in model.state_dict()
                                  if not k.endswith("num_batches_tracked")}
    for k in ft:
        assert torch.equal(fj[k], ft[k]), k
        assert torch.allclose(ft[k], model.state_dict()[k].half().float())

    # resuming from the checkpoint restores model and optimizer; training
    # on to epoch 3 takes the remaining epoch only
    _, state3 = TL.fit(cfg, batches, lambda: [], n_epochs=3,
                       log_dir=str(tmp_path / "runs"),
                       ckpt_dir=str(tmp_path / "ckpt"), resume=True,
                       device="cpu")
    assert state3.optimizer.count == 6
    # a warm start from the export: a fresh optimizer, the schedule offset
    # to the export's epoch
    _, warm = TL.fit(cfg, batches, lambda: [], n_epochs=3,
                     log_dir=str(tmp_path / "runs2"), init_from=npz,
                     device="cpu")
    assert warm.optimizer.count == 2
    assert warm.optimizer.sched(0) == cfg.train.lr
    assert os.path.exists(npz)


# ------------------------------------------------- loss, config, weights
def test_mae_loss_matches_jax():
    from tdvnet.eval import metrics2d as J
    from tdvnet_torch.eval import metrics2d as T

    rng = np.random.default_rng(4)
    gt = rng.uniform(0.5, 5, (3, 12, 16)).astype(np.float32)
    gt[0, :3] = 0.0
    gt[2] = 0.0                       # an image without valid pixels
    pred = (gt + rng.normal(0, 0.2, gt.shape)).astype(np.float32)
    for w in (None, np.array([1, 1, 0], np.float32),
              np.zeros(3, np.float32)):
        a = float(J.mae_loss(pred, gt, 0.05, w))
        b = float(T.mae_loss(t(pred), t(gt), 0.05,
                             None if w is None else t(w)))
        assert abs(a - b) <= 1e-6 * max(abs(a), 1.0), (w, a, b)


def test_train_config_defaults_match_jax():
    import dataclasses

    from tdvnet.config import TrainConfig as JT
    from tdvnet_torch.config import Config, TrainConfig

    ours = dataclasses.asdict(TrainConfig())
    theirs = dataclasses.asdict(JT())
    assert ours == {k: theirs[k] for k in ours}
    assert Config().train == TrainConfig()


def test_to_flax_variables_round_trips_the_jax_tree():
    from tdvnet.models.threedvnet import ThreeDVNet as JNet
    from tdvnet_torch.config import tiny_test_config
    from tdvnet_torch.models.threedvnet import ThreeDVNet
    from tdvnet_torch.weights import load_flax_into, to_flax_variables

    cfg_j = jax_tiny_config()
    jb, _ = both_batches(cfg_j, [0])
    v = _init_variables(JNet(cfg_j.model), jb, offsets=[0.05], n_iters=1,
                        lam=0.0, train=False, seed=7)
    m = ThreeDVNet(tiny_test_config().model)
    load_flax_into(m, v)
    back = to_flax_variables(m)
    flat = lambda tree: {k: np.asarray(x) for k, x in
                         jax.tree_util.tree_flatten_with_path(tree)[0]}
    a, b = flat(v), flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))


def test_refinement_step_trains_the_scene_stages_on_cpu():
    """n_iters=1 on the CPU: the twins carry the gradient into the PointNet,
    the scene U-Net and the decoder; the points themselves take none."""
    from tdvnet_torch.config import tiny_test_config
    from tdvnet_torch.data import batch as B, synthetic
    from tdvnet_torch.train import loop as TL

    cfg = tiny_test_config()
    bc = cfg.batch
    batch = B.collate_scenes(
        [synthetic.make_batch_scene(bc.n_views, bc.img_size,
                                    bc.depth_img_size, seed=2)],
        bc.n_views, bc.n_ref, bc.n_src_on_either_side)
    st = TL.create_state(cfg, 1, "cpu")
    st, mets = TL.make_train_step(st.model, cfg, 1)(st, batch, 0.5)
    assert np.isfinite(float(mets["loss"]))
    assert float(mets["loss"]) > float(mets["loss_2d"])
    for name in ("pointnet", "scene_unet", "decoder"):
        g = [p.grad for p in getattr(st.model, name).parameters()]
        assert all(x is not None for x in g)
        assert any(float(x.abs().max()) > 0 for x in g), name
