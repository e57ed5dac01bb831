"""CUDA-event timing and the bf16 ulp comparison shared by the probe tools
and `chip_smoke.py` (the card only)."""
from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet: a byte bound's rate


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds per call of `fn` on the current CUDA stream."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bf16_ulp(m: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at magnitudes m (a tensor)."""
    _, e = torch.frexp(m.double())
    return torch.ldexp(torch.ones_like(m, dtype=torch.float64), e - 8)


def bf16_over_ulp(got: torch.Tensor, want: torch.Tensor) -> int:
    """How many elements lie more than one bf16 ulp of the larger of their
    two magnitudes apart (a NaN on either side counts)."""
    a, b = got.double(), want.double()
    near = (a - b).abs() <= bf16_ulp(torch.maximum(a.abs(), b.abs()))
    return int((~near).sum())


def bf16_ulp_ok(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Every element within one bf16 ulp of the larger of its two
    magnitudes (two fp32 sums in another order may round to neighbouring
    bf16 values)."""
    return bf16_over_ulp(got, want) == 0
