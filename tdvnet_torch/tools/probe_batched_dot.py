"""Probe: a batch of small bf16 matrix products rounded once to bf16 on the
card, the port's counterpart of `tools/probe_mosaic_batched_dot.py`.

    python -m tdvnet_torch.tools.probe_batched_dot

The shape is the tool's: NB=432 cells x X=80 products of [56, 64] @
[64, 32] in bf16 (the pass-1 products of the two-pass warp), each sum
rounded to bf16 once. One line per case: OK or FAIL against the plain
twin, the exact sum rounded (every element within one bf16 ulp; ">ulp"
marks a library call whose fp32 sums round elsewhere), the time per call
with CUDA events, and TF/s; then the kernel's share of elements bit-equal to the twin, its
factor against the library call and its share of the byte bound. The
hand kernel (`kernels.probes.batched_dot`) stands for the tool's Pallas
kernels (`pallas_batched2`, `pallas_loop`); `torch.matmul` on the same
bf16 tensors stands for its XLA line, a library yardstick the port never
calls. `RAGGED` lists the other shapes the card checks the kernel at.
"""
from __future__ import annotations

import torch

from tdvnet_torch.config import resolve_device, set_fp32_numerics
from tdvnet_torch.kernels.probes import batched_dot, batched_dot_ref
from tdvnet_torch.tools.timing import (HBM_BYTES_PER_S, bf16_over_ulp,
                                       bf16_ulp_ok, time_ms)

NB, X, Q, Y, C = 432, 80, 56, 64, 32

# (leading dims, Q, Y, C): ragged row counts (1, 17, 33, 56, 200, 256),
# one 8-column tile (C=8: the x2 load), two (16), two column chunks of a
# warp (64), each row swizzle of W (Y = 16, 32, 64), product counts that
# are no multiple of the grid (1, 5, 4321), two batch dims, and the
# largest shape the kernel takes
RAGGED = (((1,), 56, 64, 32), ((5,), 17, 64, 8), ((4321,), 64, 64, 32),
          ((4321,), 17, 64, 32), ((5,), 56, 64, 8), ((6, 7), 56, 64, 32),
          ((3, 5), 64, 64, 8), ((9,), 33, 32, 16), ((7,), 200, 16, 64),
          ((11,), 1, 64, 64), ((3,), 256, 64, 64))


def make_inputs(device, nb: int = NB, x: int = X, seed: int = 0):
    """W [nb, x, Q, Y] and F [nb, x, Y, C], standard normal in bf16, drawn
    on `device` from `seed`."""
    return make_shaped(device, (nb, x), Q, Y, C, seed)


def make_shaped(device, lead, q: int, y: int, c: int, seed: int = 0):
    """W [*lead, q, y] and F [*lead, y, c], standard normal in bf16, drawn
    on `device` from `seed`."""
    g = torch.Generator(device=device).manual_seed(seed)
    W = torch.randn((*lead, q, y), generator=g, device=device)
    F = torch.randn((*lead, y, c), generator=g, device=device)
    return W.to(torch.bfloat16), F.to(torch.bfloat16)


def flops(W: torch.Tensor, F: torch.Tensor) -> float:
    return 2.0 * W.numel() * F.shape[-1]


def nbytes(W: torch.Tensor, F: torch.Tensor) -> float:
    """Each input read once and the bf16 output written once."""
    out = W.numel() // W.shape[-1] * F.shape[-1]
    return 2.0 * (W.numel() + F.numel() + out)


def run(device=None, nb: int = NB, iters: int = 20):
    """Check and time the hand kernel, its twin and the library call on the
    card; prints one line each and returns one record."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the probe measures the card: pass a CUDA device")
    set_fp32_numerics()
    W, F = make_inputs(dev, nb)
    fl = flops(W, F)
    want = batched_dot_ref(W, F)
    got = batched_dot(W, F)
    rec = {"name": f"batched_dot NB={nb} x {X} x [{Q},{Y}]@[{Y},{C}]",
           "ok": bf16_ulp_ok(got, want),
           "max_abs_err": float((got.float() - want.float()).abs().max()),
           "bit_equal": float((got == want).double().mean()),
           "library_over_ulp": bf16_over_ulp(torch.matmul(W, F), want),
           "nbytes": nbytes(W, F), "flops": fl}
    for key, label, fn in (
            ("ms", "hand kernel batched_dot", lambda: batched_dot(W, F)),
            ("plain_ms", "plain twin (float64 matmul, rounded)",
             lambda: batched_dot_ref(W, F)),
            ("library_ms", "library torch.matmul bf16",
             lambda: torch.matmul(W, F))):
        ms = rec[key] = time_ms(fn, iters)
        # the library call is a yardstick: its fp32 sums, in its own order,
        # round more than an ulp away from the exact sum where it cancels
        if key == "library_ms":
            verdict = ">ulp" if rec["library_over_ulp"] else "OK  "
        else:
            verdict = "OK  " if rec["ok"] else "FAIL"
        print(f"{label:<46s} {verdict} {ms:9.4f} ms "
              f"{fl / (ms * 1e-3) / 1e12:7.2f} TF/s", flush=True)
    print(f"library torch.matmul: {rec['library_over_ulp']} of "
          f"{want.numel()} elements over one bf16 ulp of the exact sum",
          flush=True)
    bound = 1e3 * rec["nbytes"] / HBM_BYTES_PER_S
    print(f"hand kernel: {rec['bit_equal']:.6f} of elements bit-equal to "
          f"the twin, {rec['ms'] / rec['library_ms']:.3f}x the library "
          f"call's time, {bound / rec['ms']:.3f} of the byte bound "
          f"({bound:.4f} ms)", flush=True)
    return rec


def main():
    return 0 if run()["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
