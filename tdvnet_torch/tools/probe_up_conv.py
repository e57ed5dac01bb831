"""Probe: the stride-2 up-conv (`models/layers.up_conv3d`) on the card.

    python -m tdvnet_torch.tools.probe_up_conv

At the inputs the full-width model gives its five up-convs (the cost
regularisation's three, at 14 refs; the scene U-Net's two at a 64^3 grid),
three forms of `conv_transpose3d(x, w, stride=2, padding=1,
output_padding=1)` in fp32: cuDNN's default pick, cuDNN's deterministic
pick, and the port's (`_UpConvFunction`: forward one plain conv with a
2x2x2 kernel over the output's eight parities, backward the transposed
conv's own). One line per shape and form: the largest
error against float64 over the largest value, whether three calls repeat
bit for bit, and the milliseconds of a forward and of a forward and
backward, with CUDA events. Exits 1 when the port's form does not repeat.
"""
from __future__ import annotations

import subprocess

import torch
import torch.nn.functional as F

from tdvnet_torch.config import resolve_device, set_fp32_numerics
from tdvnet_torch.models.layers import _UpConvFunction
from tdvnet_torch.tools.timing import time_ms

# (input [B, C, D, H, W], output channels)
SHAPES = (((14, 64, 12, 7, 7), 32), ((14, 32, 24, 14, 14), 16),
          ((14, 16, 48, 28, 28), 8), ((2, 128, 16, 16, 16), 128),
          ((2, 128, 32, 32, 32), 64))


def _cudnn(x, w):
    return F.conv_transpose3d(x, w, stride=2, padding=1, output_padding=1)


FORMS = (("cuDNN default", _cudnn, False),
         ("cuDNN deterministic", _cudnn, True),
         ("port (polyphase)", _UpConvFunction.apply, False))


def run(device=None, shapes=SHAPES, seed: int = 0):
    device = resolve_device(device)
    set_fp32_numerics()
    gen = torch.Generator().manual_seed(seed)
    recs = []
    for xs, co in shapes:
        x = torch.randn(*xs, generator=gen).to(device)
        w = (torch.randn(xs[1], co, 3, 3, 3, generator=gen)
             / (27 * xs[1]) ** 0.5).to(device)
        want = _cudnn(x.double(), w.double())
        scale = float(want.abs().max())
        for name, fn, det in FORMS:
            before = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = det
            try:
                ys = [fn(x, w) for _ in range(3)]
                xr = x.clone().requires_grad_()
                wr = w.clone().requires_grad_()
                gy = torch.randn_like(ys[0])

                def step():
                    xr.grad = wr.grad = None
                    fn(xr, wr).backward(gy)

                on_card = device.type == "cuda"
                rec = {"shape": f"{tuple(xs)} -> {co}", "form": name,
                       "rel_err": max(float((y.double() - want).abs().max())
                                      / scale for y in ys),
                       "repeats": all(torch.equal(ys[0], y) for y in ys[1:]),
                       "fwd_ms": time_ms(lambda: fn(x, w)) if on_card
                       else None,
                       "fwd_bwd_ms": time_ms(step) if on_card else None}
            finally:
                torch.backends.cudnn.deterministic = before
            recs.append(rec)
            ms = (f"forward {rec['fwd_ms']:.3f} ms, forward+backward "
                  f"{rec['fwd_bwd_ms']:.3f} ms" if rec["fwd_ms"] is not None
                  else "not timed off the card")
            print(f"{rec['shape']:28s} {name:20s} err {rec['rel_err']:.2e} "
                  f"repeats {rec['repeats']!s:5s} {ms}", flush=True)
    return recs


def main():
    if torch.cuda.is_available():
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    recs = run()
    return 0 if all(r["repeats"] for r in recs
                    if r["form"].startswith("port")) else 1


if __name__ == "__main__":
    raise SystemExit(main())
