"""The training knobs of the port (`TrainConfig.grad_accum_steps`, `remat`,
`bf16_compute`) against the JAX package at the tiny config.

- grad_accum_steps: the port's `Optimizer` against
  `optax.MultiSteps(multi_transform(adam, set_to_zero), k)` fed the same
  gradients (no model), and JAX's `test_grad_accum_matches_large_batch`
  property on the port's step; the schedule counts updates; a checkpoint
  taken between microsteps resumes there.
- remat: the rematerialised step is the plain step bit for bit (loss,
  parameters, BatchNorm statistics) at n_iters 0 and 1.
- bf16_compute: the port's |bf16 - fp32| of one n_iters=1 step (the loss
  and the gradient norm per module), pooled over ten tiny scenes, within
  1.5x JAX's |bf16_compute - the port's fp32| (the port's fp32 step stands
  for JAX's: the two agree to ~1e-5, far under bf16's error), from the
  same weights; the one JAX compile of the module is that bf16 step. Its
  parameters come from the port's own initialisation through
  `to_flax_variables`, so JAX's `create_state` never runs. Then JAX's
  `test_bf16_train_step_runs_and_learns` on the port, and the six bf16
  backward forms' twins against their float64 referees
  (`chip_smoke.bf16_grad_check`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_helpers import both_batches, jax_tiny_config, n
from _torch_helpers import torch_one_thread  # noqa: F401 (autouse)

BF = torch.bfloat16
SEEDS = tuple(range(4, 14))
ERR_RATIO = 1.5
MODULES = ("mvsnet.backbone", "mvsnet.fpn", "mvsnet.cost_reg", "pointnet",
           "scene_unet", "decoder", "refine_quarter", "refine_half",
           "refine_full")


def _knobs(cfg, **kw):
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                              **kw))


def _tiny_batch(seed):
    from tdvnet_torch.config import tiny_test_config

    return both_batches(tiny_test_config(), [seed])[1]


# ---------------------------------------------------------- grad_accum_steps
def test_accumulating_optimizer_matches_optax_multisteps():
    """Four microsteps at k=2 of the port's Optimizer and of optax's
    MultiSteps around the frozen-leaf multi_transform, fed the same
    gradients, with a frozen leaf (not in the port's optimizer) and a leaf
    the loss never reaches (no grad: a zero gradient). After every
    microstep the mini-step and the update count are optax's, and the
    parameters, Adam's moments and the running mean lie within 1e-7 (and
    1e-7 of the value past 1) of a float64 rerun of MultiSteps' rules, and
    within 1e-7 plus optax's own distance from that rerun of optax's
    (torch's Adam and optax's order their fp32 operations apart: optax's
    parameters read up to 2e-7 off the float64 rerun here, the port's
    4e-8)."""
    from tdvnet_torch.train.loop import Optimizer, make_lr_schedule

    rng = np.random.default_rng(0)
    init = {"w": rng.normal(size=(3, 4)).astype(np.float32),
            "frozen": rng.normal(size=(4,)).astype(np.float32),
            "unreached": rng.normal(size=(5,)).astype(np.float32)}
    # lr halves every update, so the schedule's count shows
    sched = make_lr_schedule(1e-2, 1, 0.5, steps_per_epoch=1)
    labels = {"w": "train", "frozen": "frozen", "unreached": "train"}
    tx = optax.MultiSteps(optax.multi_transform(
        {"train": optax.adam(sched), "frozen": optax.set_to_zero()},
        labels), every_k_schedule=2)
    params_j = {k: jnp.asarray(v) for k, v in init.items()}
    state_j = tx.init(params_j)
    w = torch.nn.Parameter(torch.from_numpy(init["w"].copy()))
    unreached = torch.nn.Parameter(torch.from_numpy(init["unreached"].copy()))
    opt = Optimizer([w, unreached], sched, accum_steps=2)
    trained = ("w", "unreached")
    # the float64 rerun: running mean, Adam's moments, the parameters
    f64 = {k: {"p": init[k].astype(np.float64),
               "acc": np.zeros(init[k].shape), "mu": np.zeros(init[k].shape),
               "nu": np.zeros(init[k].shape)} for k in trained}

    def close(got, exact, jax_val):
        np.testing.assert_allclose(got, exact, rtol=1e-7, atol=1e-7)
        slack = np.abs(np.asarray(jax_val, np.float64) - exact)
        assert (np.abs(got - np.asarray(jax_val, np.float64))
                <= 1e-7 * np.maximum(1.0, np.abs(exact)) + slack).all()

    for i in range(4):
        g = (rng.normal(size=(3, 4)) * 10.0 ** (i - 2)).astype(np.float32)
        grads = {"w": jnp.asarray(g),
                 "frozen": jnp.asarray(rng.normal(size=(4,)), jnp.float32),
                 "unreached": jnp.zeros((5,), jnp.float32)}
        upd, state_j = tx.update(grads, state_j, params_j)
        params_j = optax.apply_updates(params_j, upd)
        opt.zero_grad()
        w.grad = torch.from_numpy(g.copy())
        updated = opt.step()
        for k in trained:
            r = f64[k]
            r["acc"] += (np.asarray(grads[k], np.float64) - r["acc"]) \
                / (i % 2 + 1)
            if i % 2:
                t = i // 2 + 1
                r["mu"] = 0.9 * r["mu"] + 0.1 * r["acc"]
                r["nu"] = 0.999 * r["nu"] + 0.001 * r["acc"] ** 2
                r["p"] = r["p"] - sched(t - 1) * (r["mu"] / (1 - 0.9 ** t)) \
                    / (np.sqrt(r["nu"] / (1 - 0.999 ** t)) + 1e-8)
                r["acc"] = np.zeros_like(r["acc"])
        assert updated == (i % 2 == 1)
        assert opt.mini_step == int(state_j.mini_step)
        assert opt.count == int(state_j.gradient_step)
        adam = state_j.inner_opt_state.inner_states["train"].inner_state[0]
        assert opt.count == int(adam.count)
        for slot, (name, p) in enumerate((("w", w), ("unreached", unreached))):
            r = f64[name]
            close(n(p).astype(np.float64), r["p"], params_j[name])
            acc = np.zeros(r["acc"].shape) if opt.acc is None \
                else n(opt.acc[slot]).astype(np.float64)
            close(acc, r["acc"], state_j.acc_grads[name])
            st = opt.adam.state.get(p, {})
            for mom, key in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
                got = n(st[mom]).astype(np.float64) if mom in st \
                    else np.zeros(r[key].shape)
                close(got, r[key], getattr(adam, key)[name])
        np.testing.assert_array_equal(np.asarray(params_j["frozen"]),
                                      init["frozen"])


def test_grad_accum_schedule_counts_updates():
    """The StepLR schedule counts updates, ceil(steps_per_epoch / k) an
    epoch, in a fresh optimizer and in a warm start's offset one (the JAX
    package's `make_tx`)."""
    from tdvnet.train import loop as JL
    from tdvnet_torch.config import tiny_test_config
    from tdvnet_torch.models.threedvnet import ThreeDVNet
    from tdvnet_torch.train import loop as TL

    cfg = _knobs(tiny_test_config(), grad_accum_steps=2, lr_step=1,
                 lr_gamma=0.5)
    model = ThreeDVNet(cfg.model)
    for start in (0, 2):
        opt = TL.make_optimizer(cfg, model, 5, start_epoch=start)
        want = JL.make_lr_schedule(1e-3, 1, 0.5, 3, step_offset=3 * start)
        assert opt.accum_steps == 2
        assert [opt.sched(i) for i in range(12)] == \
            [want(i) for i in range(12)]
    with pytest.raises(ValueError):
        _knobs(cfg, grad_accum_steps=0)


def test_grad_accum_step_and_checkpoint_between_microsteps(tmp_path):
    """JAX's `test_grad_accum_matches_large_batch` on the port's step: after
    microstep 1 every parameter keeps its bits (the BatchNorm statistics
    move), after microstep 2 they update. A checkpoint taken after
    microstep 1 resumes at that mini-step with its running mean, and its
    second microstep gives the same parameters; a regime of another k
    refuses it."""
    from tdvnet_torch.config import tiny_test_config
    from tdvnet_torch.train import checkpoints as C
    from tdvnet_torch.train import loop as TL

    cfg = _knobs(tiny_test_config(), grad_accum_steps=2)
    batch = _tiny_batch(3)
    st = TL.create_state(cfg, 1, "cpu")
    step = TL.make_train_step(st.model, cfg, 0)
    p0 = [p.detach().clone() for p in st.model.parameters()]
    stats0 = st.model.mvsnet.cost_reg.ConvBnRelu_0.BatchNorm_0 \
        .running_var.clone()
    st, _ = step(st, batch, 0.5)
    assert all(torch.equal(a, b) for a, b in zip(p0, st.model.parameters()))
    assert not torch.equal(stats0, st.model.mvsnet.cost_reg.ConvBnRelu_0
                           .BatchNorm_0.running_var)
    assert (st.optimizer.mini_step, st.optimizer.count) == (1, 0)
    C.save(str(tmp_path), st, 1, cfg)
    st, _ = step(st, batch, 0.5)
    assert (st.optimizer.mini_step, st.optimizer.count) == (0, 1)
    assert any(not torch.equal(a, b)
               for a, b in zip(p0, st.model.parameters()))
    back = TL.create_state(cfg, 1, "cpu")
    back, epoch = C.restore(str(tmp_path), back)
    assert epoch == 1 and back.optimizer.mini_step == 1
    back, _ = TL.make_train_step(back.model, cfg, 0)(back, batch, 0.5)
    assert all(torch.equal(a, b) for a, b in zip(st.model.parameters(),
                                                 back.model.parameters()))
    other = TL.create_state(_knobs(cfg, grad_accum_steps=3), 1, "cpu")
    with pytest.raises(ValueError, match="accumulates"):
        C.restore(str(tmp_path), other)


# --------------------------------------------------------------------- remat
@pytest.mark.parametrize("n_iters", [0, 1])
def test_remat_step_is_the_plain_step_bit_for_bit(n_iters):
    """One checkpoint around the whole forward (`jax.checkpoint(forward)`):
    the rerun in the backward leaves the BatchNorms' running statistics
    where the first run moved them, so the loss, every parameter and every
    buffer after two steps are the plain steps' bits."""
    from tdvnet_torch.config import tiny_test_config
    from tdvnet_torch.train import loop as TL

    batch = _tiny_batch(5)
    out = {}
    for remat in (False, True):
        cfg = _knobs(tiny_test_config(), remat=remat)
        st = TL.create_state(cfg, 1, "cpu")
        step = TL.make_train_step(st.model, cfg, n_iters)
        losses = []
        for _ in range(2):
            st, mets = step(st, batch, 0.5)
            losses.append(mets["loss"])
        out[remat] = (losses, st.model.state_dict())
    (la, sa), (lb, sb) = out[False], out[True]
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


# ---------------------------------------------------------------------- bf16
@pytest.fixture(scope="module")
def bf16_steps():
    """One n_iters=1 step from the same weights on each of ten tiny scenes:
    JAX's with bf16_compute, the port's fp32 (torch's own convolutions on
    the CPU: oneDNN's fp32 backward is ~1e-3 off where BatchNorm's sums
    cancel) and the port's bf16. Per step the loss and the gradient norm
    per module."""
    from tdvnet.models.threedvnet import ThreeDVNet as JNet
    from tdvnet.train import loop as JL
    from tdvnet_torch.config import tiny_test_config
    from tdvnet_torch.models.threedvnet import ThreeDVNet
    from tdvnet_torch.train import loop as TL
    from tdvnet_torch.weights import (from_flax_variables, load_flax_into,
                                      to_flax_variables)
    from _torch_helpers import adam_grads

    cfg_j = _knobs(jax_tiny_config(), bf16_compute=True)
    cfg_t = tiny_test_config()
    torch.manual_seed(0)
    variables = to_flax_variables(ThreeDVNet(cfg_t.model))
    # what the JAX package's `create_state` builds for bf16_compute
    model_j = JNet(dataclasses.replace(cfg_j.model, dtype=jnp.bfloat16))
    step_j = JL.make_train_step(model_j, cfg_j, 1, donate=False)
    lam = 0.5

    def norms(named):
        return {m: float(np.sqrt(sum(float((v.double() ** 2).sum())
                                     for k, v in named.items()
                                     if k.startswith(m + "."))))
                for m in MODULES}

    # one state for every scene (the step does not donate it): a new
    # optimizer or apply_fn is a new static field of the state, and a new
    # compile
    state = JL.TrainState.create(
        apply_fn=model_j.apply, params=variables["params"],
        tx=JL.make_tx(cfg_j, variables["params"], 1),
        batch_stats=variables["batch_stats"])
    out = {"jax": [], "fp32": [], "bf16": []}
    for seed in SEEDS:
        jb, tb = both_batches(cfg_j, [seed])
        new, mets = step_j(state, jb, jnp.float32(lam))
        g = adam_grads(new.opt_state, new.params)
        g = jax.tree.map(lambda x: np.zeros(1, np.float32) if x is None
                         else x, g, is_leaf=lambda x: x is None)
        out["jax"].append((float(mets["loss"]), norms(from_flax_variables(
            {"params": g}))))
        for name, dtype in (("fp32", torch.float32), ("bf16", BF)):
            model = ThreeDVNet(dataclasses.replace(cfg_t.model, dtype=dtype))
            load_flax_into(model, variables)
            st = TL.TrainState(model, TL.make_optimizer(cfg_t, model, 1))
            with torch.backends.mkldnn.flags(enabled=dtype == BF):
                st, mets = TL.make_train_step(model, cfg_t, 1)(st, tb, lam)
            out[name].append((float(mets["loss"]), norms(
                {k: p.grad for k, p in model.named_parameters()
                 if p.grad is not None})))
    return out


def test_bf16_step_error_within_jax_own(bf16_steps):
    """|bf16 - fp32| of the loss and of each module's gradient norm,
    pooled (the mean over the ten scenes), at most 1.5x JAX's."""
    fp32 = bf16_steps["fp32"]
    err = {}
    for name in ("jax", "bf16"):
        rows = bf16_steps[name]
        err[name] = {"loss": np.mean([abs(a[0] - b[0])
                                      for a, b in zip(rows, fp32)])}
        for m in MODULES:
            err[name][m] = np.mean([abs(a[1][m] - b[1][m])
                                    for a, b in zip(rows, fp32)])
    for k, j in err["jax"].items():
        print(f"{k}: port {err['bf16'][k]:.3e}, JAX {j:.3e}")
        assert err["bf16"][k] <= ERR_RATIO * j, (k, err["bf16"][k], j)


def test_bf16_train_step_runs_and_learns():
    """JAX's `test_bf16_train_step_runs_and_learns` on the port: five bf16
    steps lower the loss, and the parameters stay fp32."""
    from tdvnet_torch.config import tiny_test_config
    from tdvnet_torch.train import loop as TL

    cfg = _knobs(tiny_test_config(), bf16_compute=True)
    st = TL.create_state(cfg, 1, "cpu")
    assert st.model.cfg.dtype == BF
    assert all(p.dtype == torch.float32 for p in st.model.parameters())
    step = TL.make_train_step(st.model, cfg, 1)
    batch = _tiny_batch(0)
    losses = []
    for _ in range(6):
        st, mets = step(st, batch, 0.5)
        losses.append(float(mets["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    assert all(p.dtype == torch.float32 for p in st.model.parameters())
    assert all(p.grad is None or p.grad.dtype == torch.float32
               for p in st.model.parameters())


# ------------------------------------------------- the bf16 backward twins
def _variance_inputs(C, seed):
    from tdvnet_torch.ops import camera

    g = torch.Generator().manual_seed(seed)
    N, R, P = 4, 3, 600
    K = torch.tensor([[40.0, 0, 40], [0, 40, 32], [0, 0, 1]]).expand(N, 3, 3)
    tv = torch.stack([torch.tensor([0.1 * i, 0.0, 0.0]) for i in range(N)])
    P_all = camera.projection_matrix(K, torch.eye(3).expand(N, 3, 3),
                                     tv).contiguous()
    pts = torch.randn(R, P, 3, generator=g) * 0.8 + torch.tensor([0, 0, 2.])
    feats = torch.randn(N, 16, 20, C, generator=g).to(BF)
    sidx = torch.tensor([[0, 1, 2], [1, 2, 3], [2, 3, 0]])
    smask = torch.tensor([[True, True, True], [True, True, False],
                          [True, False, True]])
    return pts, feats, sidx, smask, P_all, (64, 80)


@pytest.mark.parametrize("C", [8, 30])
def test_bf16_backward_twins_against_float64_referees(C):
    """The plain twins of the six bf16 backward forms (the fp32 backward on
    the widened bf16 inputs, rounded once to bf16) against the float64
    referees the card holds the kernels to: K3's gather and K4's pool bit
    for bit, the sums within one bf16 ulp (K1/K2 plus its allowance for
    samples that round to the neighbouring bf16 value)."""
    import chip_smoke
    from tdvnet_torch.kernels import groupnorm, segmax, trilinear, variance
    from tdvnet_torch.kernels import voxelize as vox

    check = chip_smoke.bf16_grad_check
    g = torch.Generator().manual_seed(C)
    # K1/K2, with a bf16 (cost volume) and an fp32 (points) grad
    pts, feats, sidx, smask, P_all, img = _variance_inputs(C, C)
    _, mean = variance.source_variance_ref(pts, feats, sidx, smask, P_all,
                                           img, with_mean=True)
    for gdt in (BF, torch.float32):
        grad = torch.randn(mean.shape, generator=g).to(gdt)
        args = (grad, mean, pts, feats, sidx, smask, P_all, img)
        twin = variance.source_variance_backward_ref(*args)
        ref, extra = chip_smoke.variance_backward_bf16_referee(*args)
        assert check(twin, twin, ref, extra=extra)[2]
    # K6
    B, dims, Q = 2, (6, 5, 7), 900
    grid_pts = torch.rand(B, Q, 3, generator=g) * 8 - 1
    c0 = torch.zeros(B, 3)
    grad = torch.randn(B, Q, C, generator=g).to(BF)
    shape = (B, *dims, C)
    twin = trilinear.trilinear_sample_backward_ref(grad, grid_pts, c0, 1.0,
                                                   shape)
    ref = trilinear.trilinear_sample_backward_ref(grad.double(), grid_pts,
                                                  c0, 1.0, shape)
    terms = trilinear.trilinear_sample_backward_ref(grad.double().abs(),
                                                    grid_pts, c0, 1.0, shape)
    assert twin.dtype == BF and check(twin, twin, ref, terms)[2]
    # K5, its three tails
    G = 2 if C % 2 == 0 else 1
    mask = (torch.rand(2, 1, 5, 4, 6, generator=g) > 0.3).float()
    x = ((torch.randn(2, C, 5, 4, 6, generator=g) + 0.2) * mask).to(BF)
    skip = (torch.randn(2, C, 5, 4, 6, generator=g) * mask).to(BF)
    w, b = torch.rand(C, generator=g) + 0.5, torch.randn(C, generator=g)
    grad = torch.randn(x.shape, generator=g).to(BF)
    for relu, sk in ((False, None), (True, None), (False, skip)):
        out = groupnorm.masked_group_norm_ref(x, mask.to(BF), G, w, b,
                                              relu=relu, skip=sk)
        twin = groupnorm.masked_group_norm_backward_ref(
            grad, x, mask.to(BF), G, w, out, 1e-5, relu, sk is not None)
        ref, terms = chip_smoke.gn_backward_bf16_referee(
            grad, x, mask.to(BF), G, w, out, relu, sk is not None)
        assert twin[0].dtype == BF and twin[1].dtype == torch.float32
        for got, r, tm, exact in zip(twin, ref, terms,
                                     (False, False, False, True)):
            if got is not None:
                assert check(got, got, r, tm, exact)[2]
    # K4's pool and concat-back
    P, n_seg, C4 = 800, 90, -(-C // 4) * 4
    y = (torch.randn(P, C4, generator=g) * 4).round().div(4).to(BF)
    seg = torch.randint(0, n_seg, (P,), generator=g)
    valid = torch.rand(P, generator=g) > 0.1
    pooled = segmax.segment_max_ref(y, seg, valid, n_seg)
    gp = torch.randn(n_seg, C4, generator=g).to(BF)
    twin = segmax.segment_max_backward_ref(gp, y, seg, valid, pooled)
    ref = segmax.segment_max_backward_ref(gp.double(), y.double(), seg,
                                          valid, pooled.double())
    assert twin.dtype == BF and check(twin, twin, ref, exact=True)[2]
    grad = torch.randn(P, 2 * C4, generator=g).to(BF)
    for relu in (False, True):
        ty, tp = segmax.gather_concat_backward_ref(grad, y, pooled, seg,
                                                   relu)
        d = (grad.double(), y.double(), pooled.double(), seg)
        ry, rp = segmax.gather_concat_backward_ref(*d, relu)
        terms = segmax.gather_concat_backward_ref(d[0].abs(), *d[1:],
                                                  relu)[1]
        assert check(ty, ty, ry, exact=True)[2]
        assert check(tp, tp, rp, terms)[2]
    # K3's gather
    A, grid = 40, (4, 5, 3)
    idx3 = torch.stack([torch.randint(0, d, (A,), generator=g)
                        for d in grid], 1)
    vg = vox._anchor_table(idx3, torch.randint(0, 2, (A,), generator=g),
                           torch.rand(A, generator=g) > 0.2)
    gd = torch.randn(2, *grid, C, generator=g).to(BF)
    twin = vox.scatter_anchors_to_dense_backward_ref(gd, vg, grid, 2)
    ref = vox.scatter_anchors_to_dense_backward_ref(gd.double(), vg, grid, 2)
    assert twin.dtype == BF and check(twin, twin, ref, exact=True)[2]

