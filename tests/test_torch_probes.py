"""The port's probe kernels' twins against the JAX package's probe
contractions, on the CPU.

`tools/probe_mosaic_batched_dot.py` and `tools/probe_mosaic_gather.py` keep
their Pallas kernels as closures inside `main()` (or as module functions
that only `main()` feeds), so the kernels are restated here, body for body,
and run through `pl.pallas_call(..., interpret=True)`, which the CPU
accepts (the TPU-only VMEM memory space of the tool's BlockSpecs is left
out). The CUDA kernels are held to these twins on the card by
tests/test_torch_cuda.py and chip_smoke.py phase 10.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from _torch_helpers import n
from _torch_helpers import torch_one_thread  # noqa: F401 (autouse)

# the tool's product shape, at a few cells of a few products
NB, X = 2, 3
Q, Y, C = 56, 64, 32


@pytest.fixture(scope="module")
def dot_inputs():
    from tdvnet_torch.tools.probe_batched_dot import make_inputs

    W, F = make_inputs("cpu", NB, X)
    return W, F


def _bf16_np(x):
    return np.asarray(jnp.asarray(n(x.float())).astype(jnp.bfloat16))


def test_batched_dot_twin_matches_xla_dot_general(dot_inputs):
    from tdvnet_torch.kernels.probes import batched_dot, batched_dot_ref

    W, F = dot_inputs
    Wj, Fj = _bf16_np(W), _bf16_np(F)
    want = jax.lax.dot_general(
        Wj, Fj, (((3,), (2,)), ((0, 1), (0, 1))),
        preferred_element_type=jnp.float32).astype(jnp.bfloat16)
    got = batched_dot_ref(W, F)
    assert got.dtype == torch.bfloat16 and got.shape == (NB, X, Q, C)
    a = n(got.float())
    b = np.asarray(want.astype(jnp.float32))
    # fp32 sums of 64 products in another order round to bf16 at most one
    # ulp apart
    ulp = np.ldexp(1.0, np.frexp(np.maximum(np.abs(a), np.abs(b)))[1] - 8)
    assert np.all(np.abs(a - b) <= ulp)
    assert np.mean(a == b) > 0.99
    # the wrapper on CPU tensors is the twin
    assert torch.equal(batched_dot(W, F), got)


@pytest.mark.parametrize("kernel", ["batched2", "loop"])
def test_batched_dot_twin_matches_pallas_probe_kernels(dot_inputs, kernel):
    """The tool's `pallas_batched2` and `pallas_loop` bodies (:112-116,
    :138-145) in interpret mode."""
    from tdvnet_torch.kernels.probes import batched_dot_ref

    W, F = dot_inputs

    def kernel_batched2(w_ref, f_ref, o_ref):
        o_ref[0] = jax.lax.dot_general(
            w_ref[0], f_ref[0], (((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32).astype(jnp.bfloat16)

    def kernel_loop(w_ref, f_ref, o_ref):
        def body(x, _):
            o_ref[0, x] = jnp.dot(w_ref[0, x], f_ref[0, x],
                                  preferred_element_type=jnp.float32) \
                .astype(jnp.bfloat16)
            return 0
        jax.lax.fori_loop(0, X, body, 0)

    body = kernel_batched2 if kernel == "batched2" else kernel_loop
    out = pl.pallas_call(
        body,
        out_shape=jax.ShapeDtypeStruct((NB, X, Q, C), jnp.bfloat16),
        grid=(NB,),
        in_specs=[pl.BlockSpec((1, X, Q, Y), lambda i: (i, 0, 0, 0)),
                  pl.BlockSpec((1, X, Y, C), lambda i: (i, 0, 0, 0))],
        out_specs=pl.BlockSpec((1, X, Q, C), lambda i: (i, 0, 0, 0)),
        interpret=True)(_bf16_np(W), _bf16_np(F))
    a = n(batched_dot_ref(W, F).float())
    b = np.asarray(out.astype(jnp.float32))
    ulp = np.ldexp(1.0, np.frexp(np.maximum(np.abs(a), np.abs(b)))[1] - 8)
    assert np.all(np.abs(a - b) <= ulp)


@pytest.fixture(scope="module")
def gather_cases():
    from tdvnet_torch.tools.probe_gather import make_inputs

    return make_inputs()


def test_take_along_axis_twin_matches_jnp_on_every_tool_case(gather_cases):
    from tdvnet_torch.kernels.probes import take_along_axis

    assert len(gather_cases) == 7
    for name, axis, vals, idx in gather_cases:
        want = np.asarray(jnp.take_along_axis(jnp.asarray(vals),
                                              jnp.asarray(idx), axis=axis))
        got = take_along_axis(torch.from_numpy(vals), torch.from_numpy(idx),
                              axis)
        np.testing.assert_array_equal(n(got), want, err_msg=name)


def test_take_along_axis_twin_matches_pallas_probe_kernels(gather_cases):
    """The tool's `taa1` and `taa0` (:62-67) through its `try_kernel`'s
    whole-array `pallas_call`, in interpret mode."""
    from tdvnet_torch.kernels.probes import take_along_axis_ref

    def taa1(g_ref, i_ref, o_ref):
        o_ref[...] = jnp.take_along_axis(g_ref[...], i_ref[...], axis=1)

    def taa0(g_ref, i_ref, o_ref):
        o_ref[...] = jnp.take_along_axis(g_ref[...], i_ref[...], axis=0)

    for name, axis, vals, idx in gather_cases:
        out = pl.pallas_call(
            taa1 if axis == 1 else taa0,
            out_shape=jax.ShapeDtypeStruct(idx.shape, jnp.float32),
            interpret=True)(jnp.asarray(vals), jnp.asarray(idx))
        got = take_along_axis_ref(torch.from_numpy(vals),
                                  torch.from_numpy(idx), axis)
        np.testing.assert_array_equal(n(got), np.asarray(out), err_msg=name)


def _jax_rule_cases():
    """Index tables along both axes of one [5, 6] value table, drawn from a
    seed in [-2n, 2n), with the edges -n, -n-1, n, n-1, -1 and 0 in each:
    in range, negative and out of range."""
    rng = np.random.RandomState(7)
    vals = rng.rand(5, 6).astype(np.float32)
    out = []
    for axis, shape in ((1, (5, 6)), (0, (4, 6)), (1, (5, 3)), (0, (7, 6))):
        n_ = vals.shape[axis]
        idx = rng.randint(-2 * n_, 2 * n_, size=shape).astype(np.int32)
        idx.reshape(-1)[:6] = [-n_, -n_ - 1, n_, n_ - 1, -1, 0]
        out.append((axis, vals, idx))
    return out


@pytest.mark.parametrize("case", range(4))
def test_take_along_axis_follows_jnp_out_of_range(case):
    """jnp.take_along_axis, which the probe kernels call, counts an index in
    [-n, 0) from the end and fills one outside [-n, n) with NaN; the twin
    and the CPU wrapper do the same (NaN positions equal, every other value
    equal)."""
    from tdvnet_torch.kernels.probes import (take_along_axis,
                                             take_along_axis_ref)

    axis, vals, idx = _jax_rule_cases()[case]
    want = np.asarray(jnp.take_along_axis(jnp.asarray(vals),
                                          jnp.asarray(idx), axis=axis))
    n_ = vals.shape[axis]
    assert np.isnan(want).any() and ((idx < 0) & (idx >= -n_)).any()
    for fn in (take_along_axis_ref, take_along_axis):
        got = n(fn(torch.from_numpy(vals), torch.from_numpy(idx), axis))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(got, want)


def test_take_along_axis_checks_its_indices():
    """Shapes and the axis are refused with ValueError; an index out of
    range is no error (jnp.take_along_axis's rule: NaN, and a negative one
    in range counts from the end)."""
    from tdvnet_torch.kernels.probes import take_along_axis

    v = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    got = take_along_axis(v, torch.full((4, 6), 6, dtype=torch.int32), 1)
    assert torch.isnan(got).all()
    got = take_along_axis(v, torch.full((2, 6), -1, dtype=torch.int32), 0)
    assert torch.equal(got, v[3:4].expand(2, 6))
    got = take_along_axis(v, torch.full((2, 6), -5, dtype=torch.int32), 0)
    assert torch.isnan(got).all()
    with pytest.raises(ValueError):
        take_along_axis(v, torch.zeros((3, 6), dtype=torch.int32), 1)
    with pytest.raises(ValueError):
        take_along_axis(v, torch.zeros((4, 6), dtype=torch.int32), 2)
    with pytest.raises(ValueError):
        take_along_axis(v, torch.zeros((4, 6, 1), dtype=torch.int32), 0)


@pytest.mark.parametrize("shape, ok", [
    ((56, 64, 32), True), ((17, 64, 8), True), ((64, 64, 32), True),
    ((1, 16, 8), True), ((256, 64, 64), True), ((200, 32, 16), True),
    ((56, 64, 36), False), ((56, 64, 24), False), ((56, 48, 32), False),
    ((56, 128, 32), False), ((0, 64, 32), False), ((257, 64, 32), False),
    ((56, 0, 32), False), ((56, 64, 0), False), ((56, 64, 128), False)])
def test_batched_dot_shape_rule(shape, ok):
    """The shapes the card's kernel takes: 1 <= Q <= 256, Y in {16, 32,
    64}, C in {8, 16, 32, 64}; the wrapper raises ValueError for any other
    shape on the card (the rule is a plain function, so it is checked
    here), and for 2^31 products or more."""
    from tdvnet_torch.kernels.probes import batched_dot_shape_error

    Q, Y, C = shape
    why = batched_dot_shape_error(Q, Y, C)
    assert (why is None) == ok, why
    assert batched_dot_shape_error(Q, Y, C, 2 ** 31) is not None
    if ok:
        assert batched_dot_shape_error(Q, Y, C, 2 ** 31 - 1) is None


def test_batched_dot_twin_is_the_exact_sum_rounded(dot_inputs):
    """The twin sums in float64 (exact here: bf16 products of normal
    draws), then rounds to fp32 and to bf16: equal to the exact rational
    sum rounded the same way."""
    from fractions import Fraction

    from tdvnet_torch.kernels.probes import batched_dot_ref

    W, F = dot_inputs
    got = batched_dot_ref(W, F)
    w, f = W[0, 0].double().numpy(), F[0, 0].double().numpy()
    for q, c in ((0, 0), (13, 7), (55, 31)):
        s = sum(Fraction(float(w[q, k])) * Fraction(float(f[k, c]))
                for k in range(Y))
        want = torch.tensor(float(s), dtype=torch.float64).float() \
            .to(torch.bfloat16)
        assert got[0, 0, q, c] == want


def test_gather_bytes_count_at_most_one_value_per_index(gather_cases):
    """The probe's byte count (its GB/s and the bound's bytes): indices and
    output once each, and no more values than the gather has indices."""
    from tdvnet_torch.tools.probe_gather import nbytes

    def count(case):
        _, _, vals, idx = case
        return nbytes(torch.from_numpy(vals), torch.from_numpy(idx))

    # axis=1 (8,128): every value reachable, read once
    assert count(gather_cases[0]) == 4.0 * 3 * 8 * 128
    # 80 index rows into 5120 value rows reach at most 80 rows of values
    _, _, vals, idx = gather_cases[-1]
    assert vals.shape == (5120, 128) and idx.shape == (80, 128)
    assert count(gather_cases[-1]) == 4.0 * 3 * 80 * 128


def test_take_along_axis_tool_out_of_range_cases_match_jnp():
    """The out-of-range cases the card checks (`probe_gather.
    out_of_range_inputs`, both kernel forms along both axes): the twin
    equals jnp.take_along_axis, NaN positions included."""
    from tdvnet_torch.kernels.probes import take_along_axis_ref
    from tdvnet_torch.tools.probe_gather import out_of_range_inputs

    for name, axis, vals, idx in out_of_range_inputs():
        want = np.asarray(jnp.take_along_axis(jnp.asarray(vals),
                                              jnp.asarray(idx), axis=axis))
        got = n(take_along_axis_ref(torch.from_numpy(vals),
                                    torch.from_numpy(idx), axis))
        assert np.isnan(want).any(), name
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                      err_msg=name)
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_up_conv_probe_runs_on_the_cpu():
    """`tools/probe_up_conv.py` at small shapes on the CPU: every form near
    float64, the port's repeating, nothing timed off the card."""
    from tdvnet_torch.tools import probe_up_conv

    recs = probe_up_conv.run("cpu", shapes=(((1, 4, 3, 4, 5), 3),
                                            ((2, 3, 2, 2, 2), 5)))
    assert len(recs) == 2 * len(probe_up_conv.FORMS)
    assert all(r["rel_err"] < 1e-6 and r["fwd_ms"] is None for r in recs)
    assert all(r["repeats"] for r in recs if r["form"].startswith("port"))
