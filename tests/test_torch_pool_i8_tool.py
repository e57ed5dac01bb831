"""The host-side counts of the K4 and K6-int8 timing tool
(`tdvnet_torch.tools.time_pool_i8`) on the CPU, against plain numpy models
on the kernels' edge inputs: the pools' segment statistics and byte bounds,
and the int8 sampling's touched nodes and anchor repeats (with the merged
grid's low-side pad)."""
import numpy as np
import pytest
import torch

import _kernel_edge_cases as E
from _torch_helpers import torch_one_thread  # noqa: F401 (autouse)


def _counted(seg, valid, n_seg):
    ok = valid & (seg >= 0) & (seg < n_seg)
    return ok, np.bincount(seg[ok], minlength=n_seg)


@pytest.mark.parametrize("case", [c[0] for c in E.POOL_CASES])
def test_segment_stats_and_pool_bounds(case):
    from tdvnet_torch.tools import time_pool_i8 as T

    y, seg, valid, n_seg = E.pool_case(case, 4)
    ok, counts = _counted(seg, valid, n_seg)
    st = T.segment_stats(torch.from_numpy(seg), torch.from_numpy(valid),
                         n_seg)
    assert st["rows"] == ok.sum() and st["n_seg"] == n_seg
    nz = counts[counts > 0]
    assert st["non_empty"] == len(nz)
    if len(nz):
        # torch's median is the lower of the two middle values
        assert st["median"] == float(np.sort(nz)[(len(nz) - 1) // 2])
        assert st["max"] == nz.max()
        assert st["share_over_long"] == pytest.approx(
            nz[nz > T.LONG_SEGMENT].sum() / ok.sum())
    rows = int(ok.sum())
    yt = torch.from_numpy(y)
    assert T.pool_bytes(yt, torch.from_numpy(seg), torch.from_numpy(valid),
                        n_seg) == 4 * (rows * 4 + n_seg * 4 + n_seg + 1
                                       + rows)
    assert T.plan_bytes(torch.from_numpy(seg), torch.from_numpy(valid),
                        n_seg) == 9 * len(seg) + 4 * (n_seg + 1 + rows)
    pooled = torch.zeros(n_seg, 4)
    used = len(np.unique(np.clip(seg, 0, n_seg - 1)))
    P = len(seg)
    assert T.concat_bytes(yt, pooled, torch.from_numpy(seg)) == \
        4 * (P * 4 + 2 * P + used * 4 + 2 * P * 4)
    if case == "long_threshold":
        assert st["max"] == 1000 and st["share_over_long"] > 0


def _reordered(plan, seed=0):
    """The plan with each segment's rows and the long ids in another
    order, as another launch of the kernel may place them."""
    from tdvnet_torch.kernels.segmax import SegmentPlan

    rng = np.random.default_rng(seed)
    offsets = plan.offsets.numpy()
    rows = plan.rows.numpy().copy()
    for a, b in zip(offsets[:-1], offsets[1:]):
        rows[a:b] = rng.permutation(rows[a:b])
    longs = plan.longs.numpy().copy()
    longs[1:1 + longs[0]] = rng.permutation(longs[1:1 + longs[0]])
    return SegmentPlan(plan.offsets, torch.from_numpy(rows),
                       torch.from_numpy(longs), plan.first)


@pytest.mark.parametrize("case", [c[0] for c in E.PLAN_CASES])
def test_plan_digest_and_bound(case):
    """The plan's digest holds what a plan fixes and nothing of the orders
    the kernel leaves free: the same for the rows of each segment and the
    long ids in another order; another for a row moved to the next
    segment, or another work partition. The plan's byte bound: ids and
    flags read once, offsets and the counted rows written once."""
    from tdvnet_torch.kernels.segmax import SegmentPlan, segment_plan_ref
    from tdvnet_torch.tools import time_pool_i8 as T

    seg, valid, n_seg = E.plan_case(case)
    ok, counts = _counted(seg, valid, n_seg)
    st, vt = torch.from_numpy(seg), torch.from_numpy(valid)
    assert T.plan_bytes(st, vt, n_seg) == 9 * len(seg) + 4 * (
        n_seg + 1 + ok.sum())
    plan = segment_plan_ref(st, vt, n_seg)
    d = T.plan_digest(plan)
    assert T.plan_digest(_reordered(plan)) == d
    if ok.sum() == 0:
        return
    s = int(np.flatnonzero(counts)[0])         # a row leaves segment s
    moved = plan.offsets.clone()
    moved[s + 1] -= 1
    assert T.plan_digest(SegmentPlan(moved, *plan[1:])) != d
    first = plan.first.clone()
    first[0] += 1
    assert T.plan_digest(SegmentPlan(plan.offsets, plan.rows, plan.longs,
                                     first)) != d


def _i8_model(shape, pts, c0, cell, off):
    """Per query: the anchor key (-1 out of range or not finite) and its
    in-grid tap mask, and the set of touched nodes, in numpy."""
    B, X, Y, Z = shape[:4]
    q = np.floor((pts - c0[:, None]) / np.float32(cell) + np.float32(off))
    keys, masks, seen = [], [], set()
    for b in range(B):
        for p in q[b]:
            if not np.isfinite(p).all() or (p < -1).any() \
                    or (p > np.array([X, Y, Z]) - 1).any():
                keys.append(-1)
                masks.append(0)
                continue
            a = p.astype(np.int64)
            keys.append(((b * X + a[0]) * Y + a[1]) * Z + a[2])
            m = 0
            for k in range(8):
                i = a + (k >> 2, k >> 1 & 1, k & 1)
                if (i >= 0).all() and (i < (X, Y, Z)).all():
                    m |= 1 << k
                    seen.add((b, *i))
            masks.append(m)
    return np.array(keys), np.array(masks), len(seen)


@pytest.mark.parametrize("case", ["grid_edges", "nonfinite", "anchor_runs",
                                  "alternating", "ragged"])
def test_i8_repeat_share_and_touched_nodes(case):
    from tdvnet_torch.tools import time_pool_i8 as T

    grid, scale, pts, c0, cell, off = E.i8_case(case, 4)
    keys, masks, touched = _i8_model(grid.shape, pts, c0, cell, off)
    args = (grid.shape, torch.from_numpy(pts), torch.from_numpy(c0), cell,
            off)
    same = (keys[1:] == keys[:-1]) & (masks[1:] == masks[:-1]) \
        & (keys[1:] >= 0)
    assert T.i8_repeat_share(*args) == pytest.approx(same.sum() / len(keys))
    assert T.i8_touched(*args) == touched > 0
    B, Q = pts.shape[:2]
    C = grid.shape[-1]
    assert T.i8_bytes((torch.from_numpy(grid), torch.from_numpy(scale),
                       torch.from_numpy(pts), torch.from_numpy(c0), cell, C,
                       0, off)) == touched * C + 4 * (pts.size + c0.size
                                                      + scale.size) \
        + 2 * B * Q * C
    if case == "anchor_runs":
        assert same.mean() > 0.5
