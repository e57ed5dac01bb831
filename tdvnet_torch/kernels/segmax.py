"""The PointNet's per-voxel max pool and its concat-back (K4), and their
gradients.

Kernels: `csrc/segment_plan.cu`, `csrc/segment_max.cu` and
`csrc/segment_max_backward.cu` (see their headers for the TPU ops they
replace, their bounds and their designs). The pool walks segments over a
plan, a CSR view of the rows that count (`segment_plan`), which `PointNet`
builds once per call and hands to its four pools; a pool given no plan
builds its own. `segment_plan_ref`, `segment_max_ref`, `gather_concat_ref`
and the `*_backward_ref` are the plain PyTorch twins; the wrappers run them
only for CPU tensors.
When autograd records a pool or a concat-back (grad mode on and an input
requiring grad), it goes through `SegmentMaxFn` or `GatherConcatFn`, whose
backwards are `segment_max_backward` and `gather_concat_backward`.

bf16 rows go to the pool's and the concat-back's bf16
forms: a max and a copy are exact in any type, so these are bit-equal to
the JAX package's bf16 ops and to an fp32 run of the same values followed
by a cast (the empty-segment threshold NEG / 2 taken in bf16, as there).
Their launches count in `segment_max.bf16_launches` and
`gather_concat.bf16_launches`. Their backwards' bf16 forms (a bf16 model in
training): the pool's share g / n in fp32, rounded once to bf16; the
concat-back's y half a masked copy and its segment sum in the fp32 form's
fixed point, rounded once to bf16 (`*_backward.bf16_launches`).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from tdvnet_torch.kernels._launch import (at_least_fp32, check, launch,
                                          on_cpu, wants_grad)

NEG = -1e30
# a segment of more rows than this is pooled by the kernel's long path
# (many blocks), not one warp; a pool warp's share of the work (a segment
# costs 1 + its rows); `csrc/segment_plan.cuh` kSegmentLong, kSegmentWork
SEGMENT_LONG = 256
SEGMENT_WORK = 32
# the pool kernel's blocks for the long path (each takes a share of every
# long segment's rows); they exit at once when the plan lists none, and are
# launched only where a segment can hold more than SEGMENT_LONG of the P
# rows. On the PointNet's path only the dump slot of an overflowing anchor
# capacity gets that long; its row is dropped from the PointNet's output.
LONG_BLOCKS = 264


class SegmentPlan(NamedTuple):
    """The rows that count for a segment max (valid, 0 <= seg < n_seg), by
    segment: segment s holds rows[offsets[s]:offsets[s + 1]] (int32; past
    offsets[n_seg] `rows` is unspecified); `longs` [1 + cap] int32 the
    number of segments of more than SEGMENT_LONG rows, then their ids; and
    `first` [n_work + 1] int32 the pools' work partition: segment s costs
    1 + its rows and starts at offsets[s] + s, and first[w] is the first
    segment that starts at or past w * SEGMENT_WORK (n_seg past the last;
    specified for w up to (offsets[n_seg] + n_seg) // SEGMENT_WORK + 1).
    The order of rows within a segment and of the long ids is unspecified
    (the kernel's changes from run to run); a max does not depend on
    it."""
    offsets: torch.Tensor
    rows: torch.Tensor
    longs: torch.Tensor
    first: torch.Tensor


def long_capacity(P: int) -> int:
    """Entries of a plan's long list: every segment of more than
    SEGMENT_LONG of P rows fits."""
    return P // (SEGMENT_LONG + 1) + 1


def work_items(P: int, n_seg: int) -> int:
    """Pool warps for P rows and n_seg segments (an upper bound of the
    plan's partition)."""
    return (P + n_seg) // SEGMENT_WORK + 1


def segment_plan_ref(seg: torch.Tensor, valid: torch.Tensor,
                     n_seg: int) -> SegmentPlan:
    """The plan by a stable argsort of the ids (the rows that do not count
    sorted past the end), a bincount and a search; long ids ascending."""
    ok = valid & (seg >= 0) & (seg < n_seg)
    key = torch.where(ok, seg, torch.full_like(seg, n_seg))
    rows = torch.argsort(key, stable=True).to(torch.int32)
    counts = torch.bincount(seg[ok], minlength=n_seg)
    offsets = torch.zeros(n_seg + 1, dtype=torch.int64, device=seg.device)
    offsets[1:] = torch.cumsum(counts, 0)
    ids = torch.nonzero(counts > SEGMENT_LONG).flatten()
    longs = torch.zeros(1 + long_capacity(seg.shape[0]), dtype=torch.int32,
                        device=seg.device)
    longs[0] = len(ids)
    longs[1:1 + len(ids)] = ids.to(torch.int32)
    starts = offsets + torch.arange(n_seg + 1, device=seg.device)
    at = torch.arange(work_items(seg.shape[0], n_seg) + 1,
                      device=seg.device) * SEGMENT_WORK
    first = torch.searchsorted(starts, at).clamp(max=n_seg)
    return SegmentPlan(offsets.to(torch.int32), rows, longs,
                       first.to(torch.int32))


def segment_max_plan_ref(y: torch.Tensor, plan: SegmentPlan,
                         n_seg: int) -> torch.Tensor:
    """`segment_max_ref` through a plan: each segment's max over its listed
    rows (a plain model of the pool kernel's walk, for the tests)."""
    offsets = plan.offsets.long()
    total = int(offsets[-1])
    ids = torch.repeat_interleave(torch.arange(n_seg, device=y.device),
                                  offsets[1:] - offsets[:-1])
    x = y[plan.rows[:total].long()]
    out = y.new_full((n_seg, y.shape[1]), NEG)
    out = out.scatter_reduce(0, ids[:, None].expand_as(x), x, "amax",
                             include_self=True)
    return torch.where(out <= NEG / 2, torch.zeros_like(out), out)


def segment_max_ref(y: torch.Tensor, seg: torch.Tensor, valid: torch.Tensor,
                    n_seg: int) -> torch.Tensor:
    """Max of the valid rows of y [P, C] per segment id, [n_seg, C]; 0 for a
    segment with no valid row. As in the JAX package, masked rows hold NEG,
    a row whose id is outside [0, n_seg) counts nowhere, a NaN of either
    sign wins, and a maximum at or below NEG / 2 reads as empty."""
    ok = valid & (seg >= 0) & (seg < n_seg)
    x = torch.where(ok[:, None], y, torch.full_like(y, NEG))
    idx = torch.where(ok, seg, torch.zeros_like(seg))
    out = x.new_full((n_seg, x.shape[1]), NEG)
    out = out.scatter_reduce(0, idx[:, None].expand_as(x), x, "amax",
                             include_self=True)
    return torch.where(out <= NEG / 2, torch.zeros_like(out), out)


def segment_max_backward_ref(grad: torch.Tensor, y: torch.Tensor,
                             seg: torch.Tensor, valid: torch.Tensor,
                             pooled: torch.Tensor) -> torch.Tensor:
    """d loss / d y [P, C] from grad = d loss / d pooled [n_seg, C] and the
    forward's result `pooled`: a valid row equal to its segment's maximum
    takes the segment's gradient divided by the number of rows tied there
    (JAX's scatter-max rule); every other row takes nothing, as do all rows
    of a segment that reads 0 for want of a valid row. bf16 rows: the
    share in fp32, rounded once to bf16."""
    if y.dtype == torch.bfloat16:
        return segment_max_backward_ref(
            at_least_fp32(grad), at_least_fp32(y), seg, valid,
            at_least_fp32(pooled)).to(torch.bfloat16)
    hit = valid[:, None] & (y == pooled[seg])
    ties = torch.zeros_like(pooled).index_add_(0, seg, hit.to(pooled.dtype))
    share = grad[seg] / ties[seg].clamp(min=1.0)
    return torch.where(hit, share, torch.zeros_like(share))


def gather_concat_ref(y: torch.Tensor, pooled: torch.Tensor,
                      seg: torch.Tensor, relu: bool = False) -> torch.Tensor:
    """cat([y, pooled[seg]], -1), [P, 2C], an id outside [0, n_seg) clamped
    into it (the JAX package's gather clamps one past the end and wraps a
    negative one; the main path's ids lie in range); with `relu`, the ReLU
    that the PointNet applies before its next linear layer is part of the
    write."""
    out = torch.cat([y, pooled[seg.clamp(0, pooled.shape[0] - 1)]], dim=-1)
    return F.relu(out) if relu else out


def gather_concat_backward_ref(grad: torch.Tensor, y: torch.Tensor,
                               pooled: torch.Tensor, seg: torch.Tensor,
                               relu: bool = False
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d loss / d y [P, C], d loss / d pooled [n_seg, C]) from grad =
    d loss / d out [P, 2C]: the first half passes to y, the second is summed
    into each row's segment; with `relu`, only where the output is
    positive. bf16 rows: the sums in fp32, each result rounded once to
    bf16."""
    if y.dtype == torch.bfloat16:
        bf = torch.bfloat16
        gy, gp = gather_concat_backward_ref(
            at_least_fp32(grad), at_least_fp32(y), at_least_fp32(pooled), seg,
            relu)
        return gy.to(bf), gp.to(bf)
    C = y.shape[1]
    gy, gp = grad[:, :C], grad[:, C:]
    if relu:
        gy = torch.where(y > 0, gy, torch.zeros_like(gy))
        gp = torch.where(pooled[seg] > 0, gp, torch.zeros_like(gp))
    return gy, torch.zeros_like(pooled).index_add_(0, seg, gp)


def _check_rows(y, seg, P, C, name, half=False):
    if C % 4:
        raise ValueError(f"{name}: C={C} must be a multiple of 4")
    check(y, "y", torch.bfloat16 if half else torch.float32, (P, C))
    check(seg, "seg", torch.int64, (P,))


def segment_plan(seg: torch.Tensor, valid: torch.Tensor,
                 n_seg: int) -> SegmentPlan:
    """Same contract as `segment_plan_ref`; one cooperative launch of the
    CUDA kernel for CUDA tensors (rows within a segment, and the long ids,
    in an order that changes from run to run). A refused launch raises."""
    if on_cpu(seg, valid):
        return segment_plan_ref(seg, valid, n_seg)
    P = seg.shape[0]
    if n_seg < 0 or P + n_seg >= 2 ** 31 - 1:
        raise ValueError(f"segment_plan: {P} rows and {n_seg} segments are "
                         f"outside the kernel's int32 indices")
    check(seg, "seg", torch.int64, (P,))
    check(valid, "valid", torch.bool, (P,))
    sizes, cap = _plan_layout(P, n_seg)
    buf = torch.empty((sum(sizes),), dtype=torch.int32, device=seg.device)
    counts, states, flags, ranks, epoch = _plan_scratch(seg.device,
                                                        n_seg + 1, P)
    launch("tdv_segment_plan", seg.device, seg.data_ptr(), valid.data_ptr(),
           buf.data_ptr(), counts, states, flags, ranks, P, n_seg, cap,
           epoch)
    segment_plan.launches += 1
    return SegmentPlan(*buf.split(sizes))


segment_plan.launches = 0
# counts the plan kernel's scan takes a block (`segment_plan.cu` kScanTile)
PLAN_SCAN_TILE = 1024
# (device index, stream): the plan's scratch, [counts it holds, points it
# holds, pointers to int32 counts (zeroed once and left zero by every
# launch), uint64 tile states and uint32 tile flags (each holding the epoch
# of the launch that last wrote it) and int32 ranks; the last epoch; the
# tensor]; and the pools' long path scratch, [uint32 rows of C maxima;
# uint32 tickets], zeroed once and left zero by every launch. Calls on one
# stream run in order, so they share them.
_PLAN_SCRATCH = {}
_LONG_SCRATCH = {}


@functools.lru_cache(maxsize=64)
def _plan_layout(P: int, n_seg: int):
    """The plan buffer's parts (offsets, rows, the long list, the work
    partition) and the long list's capacity."""
    cap = long_capacity(P)
    return (n_seg + 1, P, 1 + cap, work_items(P, n_seg) + 1), cap


def _stream_key(dev):
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return index, torch._C._cuda_getCurrentRawStream(index)


def _plan_scratch(dev, n, P):
    """Pointers to n zero int32 counts, the scan's uint64 tile states and
    uint32 tile flags, and P int32 ranks of the plan's scratch on `dev`'s
    current stream, and this call's epoch (counted up from 1; no tile state
    or flag holds it yet)."""
    key = _stream_key(dev)
    have = _PLAN_SCRATCH.get(key)
    if have is None or have[0] < n or have[1] < P:
        n = max(n, 1 << 16, 0 if have is None else have[0])
        n += n % 2                        # the tile states 8-byte aligned
        P = max(P, 1 << 16, 0 if have is None else have[1])
        tiles = n // PLAN_SCAN_TILE + 1
        t = torch.zeros((n + 3 * tiles + P,), dtype=torch.int32, device=dev)
        ptr = t.data_ptr()
        have = _PLAN_SCRATCH[key] = [n, P, ptr, ptr + 4 * n,
                                     ptr + 4 * (n + 2 * tiles),
                                     ptr + 4 * (n + 3 * tiles), 0, t]
    have[6] = have[6] % (2 ** 31 - 2) + 1
    return have[2], have[3], have[4], have[5], have[6]


def _long_scratch(dev, n_rows, C):
    """Pointers to the pool's long-path scratch for n_rows segments of C
    channels on `dev`'s current stream."""
    key = _stream_key(dev)
    have = _LONG_SCRATCH.get(key)
    if have is None or have[0].numel() < n_rows * C \
            or have[1].numel() < n_rows:
        n_rows = max(n_rows, 64)
        have = _LONG_SCRATCH[key] = (
            torch.zeros((n_rows * max(C, 128),), dtype=torch.int32,
                        device=dev),
            torch.zeros((n_rows,), dtype=torch.int32, device=dev))
    return have[0].data_ptr(), have[1].data_ptr()


def _segment_max(y, seg, valid, n_seg, plan):
    P, C = y.shape
    half = y.dtype == torch.bfloat16
    _check_rows(y, seg, P, C, "segment_max", half)
    check(valid, "valid", torch.bool, (P,))
    if C > 12288:
        raise ValueError(f"segment_max: C={C} is more than the long path's "
                         f"48 KB of shared memory holds")
    if plan is None:
        plan = segment_plan(seg, valid, n_seg)
    cap = long_capacity(P)
    n_work = work_items(P, n_seg)
    check(plan.offsets, "plan.offsets", torch.int32, (n_seg + 1,))
    check(plan.rows, "plan.rows", torch.int32, (P,))
    check(plan.longs, "plan.longs", torch.int32, (1 + cap,))
    check(plan.first, "plan.first", torch.int32, (n_work + 1,))
    out = torch.empty((n_seg, C), dtype=y.dtype, device=y.device)
    n_long_blocks = LONG_BLOCKS if P > SEGMENT_LONG else 0
    acc, tickets = _long_scratch(y.device, cap, C) if n_long_blocks \
        else (0, 0)
    launch("tdv_segment_max_bf16" if half else "tdv_segment_max", y.device,
           y.data_ptr(), plan.offsets.data_ptr(), plan.rows.data_ptr(),
           plan.longs.data_ptr(), plan.first.data_ptr(), acc, tickets,
           out.data_ptr(), C, n_seg, n_work, n_long_blocks)
    if half:
        segment_max.bf16_launches += 1
    else:
        segment_max.launches += 1
    return out


class SegmentMaxFn(torch.autograd.Function):
    """`segment_max` with its hand backward."""

    @staticmethod
    def forward(ctx, y, seg, valid, n_seg, plan):
        pooled = _segment_max(y, seg, valid, n_seg, plan)
        ctx.save_for_backward(y, seg, valid, pooled)
        return pooled

    @staticmethod
    def backward(ctx, grad):
        return (segment_max_backward(grad.contiguous(), *ctx.saved_tensors),
                None, None, None, None)


def segment_max(y: torch.Tensor, seg: torch.Tensor, valid: torch.Tensor,
                n_seg: int, plan: Optional[SegmentPlan] = None
                ) -> torch.Tensor:
    """`segment_max_ref`; on the card through `plan`, the ids' segment plan
    (`segment_plan(seg, valid, n_seg)`, built here when not given)."""
    if on_cpu(y, seg, valid):
        return segment_max_ref(y, seg, valid, n_seg)
    if wants_grad(y):
        return SegmentMaxFn.apply(y, seg, valid, n_seg, plan)
    return _segment_max(y, seg, valid, n_seg, plan)


segment_max.launches = 0
segment_max.bf16_launches = 0


def segment_max_backward(grad: torch.Tensor, y: torch.Tensor,
                         seg: torch.Tensor, valid: torch.Tensor,
                         pooled: torch.Tensor) -> torch.Tensor:
    """Same contract as `segment_max_backward_ref`; launches the CUDA kernel
    for CUDA tensors (its bf16 form for bf16 rows)."""
    if on_cpu(grad, y, seg, valid, pooled):
        return segment_max_backward_ref(grad, y, seg, valid, pooled)
    P, C = y.shape
    n_seg = pooled.shape[0]
    half = y.dtype == torch.bfloat16
    _check_rows(y, seg, P, C, "segment_max_backward", half)
    check(valid, "valid", torch.bool, (P,))
    check(pooled, "pooled", y.dtype, (n_seg, C))
    check(grad, "grad", y.dtype, (n_seg, C))
    ties = torch.empty((n_seg, C), dtype=torch.int32, device=y.device)
    out = torch.empty_like(y)
    launch("tdv_segment_max_backward_bf16" if half
           else "tdv_segment_max_backward", y.device, grad.data_ptr(),
           y.data_ptr(), seg.data_ptr(), valid.data_ptr(), pooled.data_ptr(),
           ties.data_ptr(), out.data_ptr(), P, C, n_seg)
    if half:
        segment_max_backward.bf16_launches += 1
    else:
        segment_max_backward.launches += 1
    return out


segment_max_backward.launches = 0
segment_max_backward.bf16_launches = 0


def _gather_concat(y, pooled, seg, relu):
    P, C = y.shape
    half = y.dtype == torch.bfloat16
    _check_rows(y, seg, P, C, "gather_concat", half)
    n_seg = pooled.shape[0]
    check(pooled, "pooled", y.dtype, (n_seg, C))
    out = torch.empty((P, 2 * C), dtype=y.dtype, device=y.device)
    launch("tdv_gather_concat_bf16" if half else "tdv_gather_concat",
           y.device, y.data_ptr(), pooled.data_ptr(), seg.data_ptr(),
           out.data_ptr(), P, C, n_seg, int(relu))
    if half:
        gather_concat.bf16_launches += 1
    else:
        gather_concat.launches += 1
    return out


class GatherConcatFn(torch.autograd.Function):
    """`gather_concat` with its hand backward."""

    @staticmethod
    def forward(ctx, y, pooled, seg, relu):
        out = _gather_concat(y, pooled, seg, relu)
        ctx.save_for_backward(y, pooled, seg)
        ctx.relu = relu
        return out

    @staticmethod
    def backward(ctx, grad):
        y, pooled, seg = ctx.saved_tensors
        gy, gp = gather_concat_backward(grad.contiguous(), y, pooled, seg,
                                        ctx.relu)
        return gy, gp, None, None


def gather_concat(y: torch.Tensor, pooled: torch.Tensor, seg: torch.Tensor,
                  relu: bool = False) -> torch.Tensor:
    if on_cpu(y, pooled, seg):
        return gather_concat_ref(y, pooled, seg, relu)
    if wants_grad(y, pooled):
        return GatherConcatFn.apply(y, pooled, seg, relu)
    return _gather_concat(y, pooled, seg, relu)


gather_concat.launches = 0
gather_concat.bf16_launches = 0


def gather_concat_backward(grad: torch.Tensor, y: torch.Tensor,
                           pooled: torch.Tensor, seg: torch.Tensor,
                           relu: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as `gather_concat_backward_ref`; launches the CUDA
    kernel for CUDA tensors (the segment sum in fixed point, so it is the
    same bits on every launch; its bf16 form for bf16 rows, the sum rounded
    once to bf16)."""
    if on_cpu(grad, y, pooled, seg):
        return gather_concat_backward_ref(grad, y, pooled, seg, relu)
    P, C = y.shape
    n_seg = pooled.shape[0]
    half = y.dtype == torch.bfloat16
    _check_rows(y, seg, P, C, "gather_concat_backward", half)
    check(pooled, "pooled", y.dtype, (n_seg, C))
    check(grad, "grad", y.dtype, (P, 2 * C))
    gy = torch.empty_like(y)
    gp = torch.empty_like(pooled)
    acc = torch.empty((n_seg, C), dtype=torch.int64, device=y.device)
    fxw = torch.empty((2,), dtype=torch.int32, device=y.device)
    launch("tdv_gather_concat_backward_bf16" if half
           else "tdv_gather_concat_backward", y.device, grad.data_ptr(),
           y.data_ptr(), pooled.data_ptr(), seg.data_ptr(), gy.data_ptr(),
           gp.data_ptr(), acc.data_ptr(), fxw.data_ptr(), P, C, n_seg,
           int(relu))
    if half:
        gather_concat_backward.bf16_launches += 1
    else:
        gather_concat_backward.launches += 1
    return gy, gp


gather_concat_backward.launches = 0
gather_concat_backward.bf16_launches = 0
