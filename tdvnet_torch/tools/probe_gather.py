"""Probe: take_along_axis on the card, the port's counterpart of
`tools/probe_mosaic_gather.py`.

    python -m tdvnet_torch.tools.probe_gather

The cases are the tool's take_along_axis cases, fp32 values and int32
indices: along axis 1 (8,128), (32,128), (8,384) and (14336,128); along
axis 0 (8,128), (80,128) and 80 index rows into 5120 value rows. On the
TPU every case whose shuffle crossed an (8, 128) tile failed to compile;
here each runs. One line per case: OK or FAIL against the plain twin
(equal), the time per call with CUDA events, and GB/s (indices and output
once, and each value the gather can reach once: no more values than
indices); then the sums over the cases, the kernel's against
`torch.take_along_dim`'s. `torch.take_along_dim` on the same tensors is
the library yardstick the port never calls; its int64 copy of the
indices is made outside its timing. `out_of_range_inputs` holds the
cases that check `jnp.take_along_axis`'s index rule on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from tdvnet_torch.config import resolve_device
from tdvnet_torch.kernels.probes import take_along_axis, take_along_axis_ref
from tdvnet_torch.tools.timing import HBM_BYTES_PER_S, time_ms

# (name, axis, value rows, value cols, index rows, index range)
CASES = (
    ("axis=1 (8,128)", 1, 8, 128, 8, 128),
    ("axis=1 (32,128)", 1, 32, 128, 32, 128),
    ("axis=1 (8,384) multi-lane-tile", 1, 8, 384, 8, 384),
    ("axis=1 (14336,128)", 1, 14336, 128, 14336, 128),
    ("axis=0 (8,128)", 0, 8, 128, 8, 8),
    ("axis=0 (80,128) multi-sublane-tile", 0, 80, 128, 80, 80),
    ("axis=0 values 5120 rows, idx 80", 0, 5120, 128, 80, 5120),
)


def make_inputs(seed: int = 0):
    """The cases' arrays as numpy, drawn in order from one
    `np.random.RandomState(seed)` as the tool draws them: values U[0, 1),
    indices floor(U[0, 1) * range)."""
    rng = np.random.RandomState(seed)
    out = []
    for name, axis, rows, cols, irows, hi in CASES:
        vals = rng.rand(rows, cols).astype(np.float32)
        idx = (rng.rand(irows, cols) * hi).astype(np.int32)
        out.append((name, axis, vals, idx))
    return out


# (axis, value rows, value cols, index rows, index cols): both kernel
# forms (cols % 4 == 0: four columns a thread; else one) along each axis
OUT_OF_RANGE = ((1, 8, 128, 8, 128), (0, 80, 128, 80, 128),
                (1, 33, 37, 33, 5), (0, 50, 7, 19, 7))


def out_of_range_inputs(seed: int = 1):
    """Per `OUT_OF_RANGE` case (name, axis, values, idx) as numpy, drawn
    from `np.random.RandomState(seed)`: indices uniform in [-2n, 2n) (a
    quarter in range, a quarter counted from the end, half NaN), with -n,
    -n-1, n and n-1 in each."""
    rng = np.random.RandomState(seed)
    out = []
    for axis, rows, cols, irows, icols in OUT_OF_RANGE:
        n = (rows, cols)[axis]
        vals = rng.rand(rows, cols).astype(np.float32)
        idx = rng.randint(-2 * n, 2 * n, size=(irows, icols)).astype(np.int32)
        idx.reshape(-1)[:4] = [-n, -n - 1, n, n - 1]
        out.append((f"axis={axis} ({irows},{icols}) into ({rows},{cols}) "
                    f"in [-2n, 2n)", axis, vals, idx))
    return out


def nbytes(values: torch.Tensor, idx: torch.Tensor) -> float:
    """The bytes a gather must move: the indices read and the output
    written once, and at most one value per index (80 index rows into 5120
    value rows read 80 rows' worth, not 5120)."""
    return 4.0 * (min(values.numel(), idx.numel()) + 2 * idx.numel())


def run(device=None, iters: int = 50):
    """Check and time each case on the card; returns one record per case
    and prints one line each."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the probe measures the card: pass a CUDA device")
    recs = []
    for name, axis, vals, idx in make_inputs():
        v = torch.from_numpy(vals).to(dev)
        i = torch.from_numpy(idx).to(dev)
        got = take_along_axis(v, i, axis)
        want = take_along_axis_ref(v, i, axis)
        ok = torch.equal(got, want)
        err = float((got - want).abs().max())
        ms = time_ms(lambda: take_along_axis(v, i, axis), iters)
        plain = time_ms(lambda: take_along_axis_ref(v, i, axis), iters)
        i64 = i.long()
        lib = time_ms(lambda: torch.take_along_dim(v, i64, axis), iters)
        gbs = nbytes(v, i) / (ms * 1e-3) / 1e9
        recs.append({"name": name, "ok": bool(ok), "max_abs_err": err,
                     "ms": ms,
                     "plain_ms": plain, "library_ms": lib, "gb_s": gbs,
                     "nbytes": nbytes(v, i)})
        print(f"{name:<44s} {'OK  ' if ok else 'FAIL'} {ms:8.4f} ms "
              f"{gbs:7.2f} GB/s  (plain {plain:.4f} ms, "
              f"torch.take_along_dim {lib:.4f} ms)", flush=True)
    ms = sum(r["ms"] for r in recs)
    lib = sum(r["library_ms"] for r in recs)
    bound = 1e3 * sum(r["nbytes"] for r in recs) / HBM_BYTES_PER_S
    print(f"sum over the {len(recs)} cases: hand kernel {ms:.4f} ms, "
          f"torch.take_along_dim {lib:.4f} ms ({ms / lib:.3f}x), byte "
          f"bound {bound:.5f} ms ({bound / ms:.4f} of it)", flush=True)
    return recs


def main():
    recs = run()
    return 0 if all(r["ok"] for r in recs) else 1


if __name__ == "__main__":
    raise SystemExit(main())
