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


def test_take_along_axis_checks_its_indices():
    from tdvnet_torch.kernels.probes import take_along_axis

    v = torch.zeros(4, 6)
    with pytest.raises(IndexError):
        take_along_axis(v, torch.full((4, 6), 6, dtype=torch.int32), 1)
    with pytest.raises(IndexError):
        take_along_axis(v, torch.full((2, 6), -1, dtype=torch.int32), 0)
    with pytest.raises(ValueError):
        take_along_axis(v, torch.zeros((3, 6), dtype=torch.int32), 1)


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
