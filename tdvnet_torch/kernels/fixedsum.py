"""The order-free fixed-point sum of the backward kernels
(`csrc/fixed_sum.cuh`), written out in plain PyTorch.

K1/K2's, K6's and the concat-back's backward kernels sum many float terms
into each output element. Float atomics would add them in an order that
changes from run to run; instead each term is rounded once to an integer,
q = rint(v * 2^k), the integers are summed in int64 (associative: every
order gives the same sum) and the sum is rounded back to fp32 once. The
power of two 2^k is set per call from a bound on the terms: k = 61 -
e_term - log2(terms an element can receive), so that no partial sum can
pass 2^62. A non-finite term adds 0 to the integer sum and is then added as
a float onto the converted result, where NaN and Inf give the same result
in any order.

`fixed_point_index_add` follows the kernels' arithmetic step by step; the
tests hold it to the float sum and to a permutation of its terms.
"""
from __future__ import annotations

import struct

import torch

SCALE_CLAMP = 120


def exp_of(amax: float) -> int:
    """e with |v| < 2^(e + 1) for the fp32 amax (its biased exponent less
    127), at least -126."""
    bits = struct.unpack("<I", struct.pack("<f", float(amax)))[0]
    return max(((bits & 0x7fffffff) >> 23) - 127, -126)


def log2_ceil(n: int) -> int:
    """ceil(log2(n)) for n >= 1."""
    return max(int(n) - 1, 0).bit_length()


def scale_exp(e_term: int, log2_terms: int) -> int:
    """k for terms below 2^e_term, at most 2^log2_terms an element."""
    return min(max(61 - e_term - log2_terms, -SCALE_CLAMP), SCALE_CLAMP)


def fixed_point_index_add(n_out: int, index: torch.Tensor,
                          terms: torch.Tensor,
                          log2_terms: int = None) -> torch.Tensor:
    """out[index[i]] += terms[i] over fp32 terms [T, ...], as the kernels
    sum: the scale from the largest finite |term| and `log2_terms`
    (default: every term could land in one element), each finite term
    rounded to an int64 (round half to even, as `__float2ll_rn`), int64
    sums, one rounding back to fp32, then the non-finite terms added as
    floats."""
    terms = terms.to(torch.float32)
    finite = torch.isfinite(terms)
    mags = torch.where(finite, terms.abs(), torch.zeros_like(terms))
    amax = float(mags.max()) if terms.numel() else 0.0
    if log2_terms is None:
        log2_terms = log2_ceil(max(terms.shape[0], 1))
    k = scale_exp(exp_of(amax) + 1, log2_terms)
    scaled = torch.where(finite, terms, torch.zeros_like(terms)) \
        * torch.tensor(2.0 ** k, dtype=torch.float32)
    q = torch.round(scaled).to(torch.int64)
    acc = torch.zeros((n_out,) + tuple(terms.shape[1:]), dtype=torch.int64)
    acc.index_add_(0, index, q)
    out = acc.to(torch.float32) * torch.tensor(2.0 ** -k,
                                               dtype=torch.float32)
    bad = torch.where(finite, torch.zeros_like(terms), terms)
    if not bool(finite.all()):
        out.index_add_(0, index, bad)
    return out
