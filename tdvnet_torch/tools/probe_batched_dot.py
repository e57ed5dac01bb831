"""Probe: a batch of small bf16 matrix products with fp32 sums on the card,
the port's counterpart of `tools/probe_mosaic_batched_dot.py`.

    python -m tdvnet_torch.tools.probe_batched_dot

The shape is the tool's: NB=432 cells x X=80 products of [56, 64] @
[64, 32] in bf16 (the pass-1 products of the two-pass warp), summed in
fp32 and rounded to bf16 once. One line per case: OK or FAIL against the
plain twin (every element within one bf16 ulp; ">ulp" marks a library
call that rounds elsewhere), the time per call with CUDA events, and
TF/s. The hand kernel (`kernels.probes.batched_dot`)
stands for the tool's Pallas kernels (`pallas_batched2`, `pallas_loop`);
`torch.matmul` on the same bf16 tensors stands for its XLA line, a
library yardstick the port never calls.
"""
from __future__ import annotations

import torch

from tdvnet_torch.config import resolve_device, set_fp32_numerics
from tdvnet_torch.kernels.probes import batched_dot, batched_dot_ref
from tdvnet_torch.tools.timing import bf16_ulp_ok, time_ms

NB, X, Q, Y, C = 432, 80, 56, 64, 32


def make_inputs(device, nb: int = NB, x: int = X, seed: int = 0):
    """W [nb, x, Q, Y] and F [nb, x, Y, C], standard normal in bf16, drawn
    on `device` from `seed`."""
    g = torch.Generator(device=device).manual_seed(seed)
    W = torch.randn((nb, x, Q, Y), generator=g, device=device)
    F = torch.randn((nb, x, Y, C), generator=g, device=device)
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
           "library_ok": bf16_ulp_ok(torch.matmul(W, F), want),
           "nbytes": nbytes(W, F), "flops": fl}
    for key, label, fn in (
            ("ms", "hand kernel batched_dot", lambda: batched_dot(W, F)),
            ("plain_ms", "plain twin (fp32 matmul, one bf16 rounding)",
             lambda: batched_dot_ref(W, F)),
            ("library_ms", "library torch.matmul bf16",
             lambda: torch.matmul(W, F))):
        ms = rec[key] = time_ms(fn, iters)
        # the library call is a yardstick: one that rounds elsewhere than
        # once from fp32 sums differs from the twin by more than an ulp
        if key == "library_ms":
            verdict = "OK  " if rec["library_ok"] else ">ulp"
        else:
            verdict = "OK  " if rec["ok"] else "FAIL"
        print(f"{label:<46s} {verdict} {ms:9.4f} ms "
              f"{fl / (ms * 1e-3) / 1e12:7.2f} TF/s", flush=True)
    return rec


def main():
    return 0 if run()["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
