"""A train step that repeats bit for bit: the fixed-point sum of the
backward kernels (`tdvnet_torch.kernels.fixedsum`, the plain model of
`csrc/fixed_sum.cuh`), the deterministic cuDNN picks that the train step's
backward takes and gives back, and a tiny n_iters=1 step that repeats on
the CPU."""
import numpy as np
import pytest
import torch

from tests._torch_helpers import torch_one_thread  # noqa: F401

from tdvnet_torch.kernels import fixedsum


def _terms(seed, T=4000, n_out=37, C=3, spread=4.0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(T, C)) * np.exp(rng.uniform(-spread, spread,
                                                     size=(T, 1)))
    idx = rng.integers(0, n_out, size=T)
    return torch.from_numpy(v.astype(np.float32)), torch.from_numpy(idx)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_fixed_point_sum_is_the_same_bits_in_any_order(seed):
    v, idx = _terms(seed)
    want = fixedsum.fixed_point_index_add(37, idx, v)
    perm = torch.from_numpy(np.random.default_rng(seed + 7).permutation(
        v.shape[0]))
    got = fixedsum.fixed_point_index_add(37, idx[perm], v[perm])
    assert torch.equal(_bits(got), _bits(want))
    # the float sum in the other order does move
    f1 = torch.zeros(37, 3).index_add_(0, idx, v)
    f2 = torch.zeros(37, 3).index_add_(0, idx[perm], v[perm])
    assert not torch.equal(_bits(f1), _bits(f2))


@pytest.mark.parametrize("seed,spread", [(2, 0.0), (3, 4.0), (4, 12.0)])
def test_fixed_point_sum_is_within_1e6_of_the_largest(seed, spread):
    v, idx = _terms(seed, spread=spread)
    got = fixedsum.fixed_point_index_add(37, idx, v)
    exact = torch.zeros(37, 3, dtype=torch.float64).index_add_(
        0, idx, v.double())
    err = float((got.double() - exact).abs().max())
    assert err <= 1e-6 * float(exact.abs().max())
    # and within fp32's own rounding of the exact sum almost everywhere
    assert err <= 4 * float(exact.abs().max()) * 2.0 ** -24


def test_fixed_point_sum_carries_nan_and_inf_as_the_float_sum():
    v, idx = _terms(5, T=64, n_out=8)
    v[3, 0], v[10, 1], v[11, 1] = float("nan"), float("inf"), float("-inf")
    v[20, 2] = float("inf")
    idx[10] = idx[11]
    got = fixedsum.fixed_point_index_add(8, idx, v)
    want = torch.zeros(8, 3).index_add_(0, idx, v)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    inf = torch.isinf(want)
    assert torch.equal(got[inf], want[inf])
    fin = torch.isfinite(want)
    assert torch.allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)
    assert int(torch.isnan(want).sum()) == 2        # NaN, and Inf - Inf


def test_fixed_point_sum_does_not_overflow_across_30_decades():
    rng = np.random.default_rng(6)
    v = np.where(rng.random((500, 2)) < 0.5, 1e30, 1e-30) \
        * rng.choice([-1.0, 1.0], size=(500, 2))
    idx = torch.from_numpy(rng.integers(0, 4, size=500))
    v = torch.from_numpy(v.astype(np.float32))
    got = fixedsum.fixed_point_index_add(4, idx, v)
    exact = torch.zeros(4, 2, dtype=torch.float64).index_add_(0, idx,
                                                              v.double())
    assert bool(torch.isfinite(got).all())
    assert float((got.double() - exact).abs().max()) \
        <= 1e-6 * float(exact.abs().max())


def test_scale_keeps_every_partial_sum_below_2_to_62():
    for amax in (1e-38, 3e-20, 1.0, 7.5, 3e30, 3.4e38):
        for log2_terms in (0, 10, 25):
            k = fixedsum.scale_exp(fixedsum.exp_of(amax) + 1, log2_terms)
            assert abs(k) <= fixedsum.SCALE_CLAMP
            if -fixedsum.SCALE_CLAMP < k < fixedsum.SCALE_CLAMP:
                assert amax * 2.0 ** k * 2 ** log2_terms < 2.0 ** 62
                assert amax * 2.0 ** k * 2 ** log2_terms >= 2.0 ** 59


def test_train_step_takes_deterministic_cudnn_in_the_backward_only():
    """The step's backward runs under cuDNN's deterministic picks; the
    flags are the caller's again after it, so inference keeps its own."""
    from tdvnet_torch.train import loop as TL

    cd = torch.backends.cudnn
    before = cd.deterministic, cd.benchmark
    seen = {}
    x = torch.ones(3, requires_grad=True)

    def hook(g):
        seen["backward"] = (cd.deterministic, cd.benchmark)
        return g

    try:
        cd.deterministic, cd.benchmark = False, True
        (x * 2).register_hook(hook)
        with TL.deterministic_cudnn():
            y = (x * 2)
            y.register_hook(hook)
            seen["forward"] = (cd.deterministic, cd.benchmark)
            y.sum().backward()
        assert (cd.deterministic, cd.benchmark) == (False, True)
        assert seen == {"forward": (True, False), "backward": (True, False)}
    finally:
        cd.deterministic, cd.benchmark = before


@pytest.fixture(scope="module")
def tiny_refine_steps():
    """Two tiny n_iters=1 train steps on the CPU, each from a fresh state
    of the same seed on the same batch, with the cuDNN flags set as
    inference leaves them."""
    from tdvnet_torch.config import tiny_test_config
    from tdvnet_torch.data import batch as B, synthetic
    from tdvnet_torch.train import loop as TL

    cfg = tiny_test_config()
    bc = cfg.batch
    batch = B.collate_scenes(
        [synthetic.make_batch_scene(bc.n_views, bc.img_size,
                                    bc.depth_img_size, seed=2)],
        bc.n_views, bc.n_ref, bc.n_src_on_either_side)
    cd = torch.backends.cudnn
    flags = cd.deterministic, cd.benchmark
    runs = []
    for _ in range(2):
        st = TL.create_state(cfg, 1, "cpu")
        st, mets = TL.make_train_step(st.model, cfg, 1)(st, batch, 0.5)
        runs.append({"loss": mets["loss"], "loss_2d": mets["loss_2d"],
                     **{f"grad {k}": p.grad for k, p
                        in st.model.named_parameters()
                        if p.grad is not None},
                     **{f"state {k}": v for k, v
                        in st.model.state_dict().items()}})
    return runs, flags, (cd.deterministic, cd.benchmark)


def test_tiny_refine_step_repeats_bit_for_bit_on_the_cpu(tiny_refine_steps):
    (a, b), flags, after = tiny_refine_steps
    assert after == flags
    assert sorted(a) == sorted(b)
    moved = [k for k in a if not torch.equal(
        a[k].reshape(-1).view(torch.uint8), b[k].reshape(-1).view(
            torch.uint8))]
    assert not moved, moved[:5]
    assert any(k.startswith("grad scene_unet") for k in a)
