"""`ThreeDVNet.infer_depth` of the port against the JAX package at the tiny
config, one scene: each stage teacher-forced (the port's stage gets the JAX
stage's inputs) at a tight tolerance, and the whole chain by the median and
the 99th percentile of |d depth| (voxelization is discontinuous, so a
1e-6 difference can move a point to another voxel)."""
import numpy as np
import pytest
import torch

from _torch_helpers import (both_batches, flax_apply, flax_variables,
                            jax_tiny_config, n, t, torch_module)
from _torch_helpers import torch_one_thread  # noqa: F401 (autouse)

OFFSETS = ((0.05, 0.025), (0.025,))


@pytest.fixture(scope="module")
def models():
    from tdvnet.models.threedvnet import ThreeDVNet as J
    from tdvnet_torch.config import tiny_test_config
    from tdvnet_torch.models.threedvnet import ThreeDVNet as T

    cfg = jax_tiny_config()
    jb, tb = both_batches(cfg, [4])
    jm = J(cfg.model)
    vs = flax_variables(jm, jb, OFFSETS, method=J.infer_depth)
    tm = torch_module(T(tiny_test_config().model), vs)
    return jm, vs, tm, jb, tb


def _jax_stages(m, batch):
    """The JAX stages of infer_depth, each stage's inputs kept."""
    dc = m.cfg.depth_test
    half, quarter, _ = m.extract_features(batch.images)
    d0, _ = m.initial_depth(batch, dc, quarter)
    d = d0
    passes = []
    for offs in OFFSETS:
        scales, origins, stats = m.model_scene(d, quarter, batch)
        for off in offs:
            delta = m.run_pointflow(scales, origins, d, quarter, batch, off, 3)
            passes.append((d, scales, origins, off, delta))
            d = d + delta
    final = m.upsample(d, half, quarter, batch.images, batch.ref_idx)
    return dict(half=half, quarter=quarter, d0=d0, refined=d, final=final,
                stats=stats, passes=passes)


@pytest.fixture(scope="module")
def stages(models):
    jm, vs, tm, jb, tb = models
    return flax_apply(jm, vs, jb, method=_jax_stages)


def _scales_to_torch(scales):
    return [{"grid": t(s["grid"]), "mask": t(s["mask"]),
             "stride": s["stride"]} for s in scales]


def test_infer_depth_end_to_end(models, stages):
    jm, vs, tm, jb, tb = models
    out = tm.infer_stages(tb, OFFSETS)
    # no stage below pushes more than ~1e-5; the chain is held by its
    # distribution because one point may change voxel
    d = np.abs(np.asarray(stages["final"]) - n(out["final"]))
    assert np.median(d) < 1e-5 and np.percentile(d, 99) < 1e-4, \
        (np.median(d), np.percentile(d, 99))
    np.testing.assert_allclose(np.asarray(stages["d0"]), n(out["initial"]),
                               rtol=1e-5, atol=1e-5)
    for k in ("n_out_of_grid", "n_overflow", "n_points"):
        assert int(stages["stats"][k]) == int(out["stats"][k]), k
    final = tm.infer_depth(tb, OFFSETS)
    assert torch.equal(final, out["final"])


def test_stage_b_initial_depth_teacher_forced(models, stages):
    jm, vs, tm, jb, tb = models
    with torch.no_grad():
        d0 = tm.initial_depth(tb, tm.cfg.depth_test, t(stages["quarter"]))
    # ~1 m depths through a 16-plane soft-argmax in fp32
    np.testing.assert_allclose(np.asarray(stages["d0"]), n(d0), rtol=1e-5,
                               atol=1e-5)


def test_stage_c_scene_model_teacher_forced(models, stages):
    from tdvnet.models.threedvnet import ThreeDVNet as J

    jm, vs, tm, jb, tb = models
    d, quarter = stages["d0"], stages["quarter"]
    sj, oj, stj = flax_apply(jm, vs, d, quarter, jb, method=J.model_scene)
    with torch.no_grad():
        st, ot, stt = tm.model_scene(t(d), t(quarter), tb)
    # bbox minimum of back-projected points: a few fp32 ulps
    np.testing.assert_allclose(np.asarray(oj), n(ot), rtol=1e-6, atol=1e-6)
    for k in stj:
        assert int(stj[k]) == int(stt[k]), k
    for a, b in zip(sj, st):
        np.testing.assert_array_equal(np.asarray(a["mask"]), n(b["mask"]))
        # PointNet, then ~20 fp32 conv + masked-GN layers of the U-Net
        np.testing.assert_allclose(np.asarray(a["grid"]), n(b["grid"]),
                                   rtol=1e-4, atol=1e-4)


def test_stage_d_pointflow_teacher_forced(models, stages):
    jm, vs, tm, jb, tb = models
    quarter = t(stages["quarter"])
    for d, scales, origins, off, delta in stages["passes"]:
        with torch.no_grad():
            got = tm.run_pointflow(_scales_to_torch(scales), t(origins),
                                   t(d), quarter, tb, float(off), 3)
        # a softmax expectation of offsets <= 0.15 m
        np.testing.assert_allclose(np.asarray(delta), n(got), rtol=1e-5,
                                   atol=1e-6)


def test_stage_e_upsample_teacher_forced(models, stages):
    jm, vs, tm, jb, tb = models
    with torch.no_grad():
        got = tm.upsample(t(stages["refined"]), t(stages["half"]),
                          t(stages["quarter"]), tb.images, tb.ref_idx)
    # three learned convex blends of ~1 m depths in fp32
    np.testing.assert_allclose(np.asarray(stages["final"]), n(got),
                               rtol=1e-5, atol=1e-5)
