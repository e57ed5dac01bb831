"""The host-side helpers of the redesigned K6 and K5 forwards and of their
timing tool, on the CPU: the statistics pass's block sizing
(`kernels.groupnorm.stats_blocks`), the sampling's byte bound
(`tools.time_sampling_gn.touched_cells`) and the scene grid the tool
places (`tools.time_sampling_gn.scene_grid`)."""
import types

import numpy as np
import pytest
import torch

import _kernel_edge_cases as E
from _torch_helpers import torch_one_thread  # noqa: F401 (autouse)

# the U-Net levels (B, C, G, V) of the batch (2 x 64^3) and of the golden
# scene (64x48x32), and two shapes off them
LEVELS = [(2, 64, 4, 64 ** 3), (2, 128, 8, 32 ** 3), (2, 128, 8, 16 ** 3),
          (1, 64, 4, 98304), (1, 128, 8, 12288), (1, 128, 8, 1536),
          (2, 8, 2, 45), (3, 24, 4, 7)]


@pytest.mark.parametrize("B,C,G,V", LEVELS)
def test_stats_blocks_fill_the_card(B, C, G, V):
    """Every slice is cut into whole channel chunks that divide C/G, and the
    grid holds at least 4 blocks an SM of a 132-SM card unless the chunks
    are single channels (or odd) already; no chunk is cut further than
    that needs."""
    from tdvnet_torch.kernels.groupnorm import (STATS_BLOCKS_PER_SM,
                                                STATS_VOXELS, stats_blocks)

    n_sm = 132
    vb, cc = stats_blocks(B, C, G, V, n_sm)
    cg = C // G
    assert vb == STATS_VOXELS and cg % cc == 0
    blocks = lambda c: B * G * -(-V // vb) * (cg // c)
    want = STATS_BLOCKS_PER_SM * n_sm
    assert blocks(cc) >= want or cc % 2 == 1
    if cc < cg:
        assert blocks(2 * cc) < want


def _touched_numpy(shape, pts, c0, cell):
    B, X, Y, Z = shape[:4]
    q = np.floor((pts - c0[:, None]) / np.float32(cell))
    seen = set()
    for b in range(B):
        for p in q[b]:
            if not np.isfinite(p).all():
                continue
            for k in range(8):
                i = p.astype(np.int64) + (k >> 2, k >> 1 & 1, k & 1)
                if (i >= 0).all() and (i < (X, Y, Z)).all():
                    seen.add((b, *i))
    return len(seen)


@pytest.mark.parametrize("case", ["grid_edges", "nonfinite", "anchor_runs",
                                  "alternating"])
def test_touched_cells_counts_each_read_node_once(case):
    from tdvnet_torch.tools.time_sampling_gn import touched_cells

    grid, pts, c0, cell = E.trilinear_forward_case(case, 4)
    got = touched_cells(grid.shape, torch.from_numpy(pts),
                        torch.from_numpy(c0), cell)
    assert got == _touched_numpy(grid.shape, pts, c0, cell) > 0


@pytest.mark.parametrize("extent", [(4.06, 4.03, 1.96), (0.5, 0.3, 0.2),
                                    (20.0, 9.0, 7.5)])
def test_scene_grid_is_fused_scene_inferences(extent):
    """The tool sizes the scene's grid as `FusedSceneInference` does:
    bucketed, capped at `eval_grid_size`."""
    import warnings

    from tdvnet_torch.config import Config, GridConfig
    from tdvnet_torch.eval.fused_scene import FusedSceneInference
    from tdvnet_torch.tools.time_sampling_gn import scene_grid

    cfg = Config()
    fake = types.SimpleNamespace(cfg=cfg, grid_cfg=GridConfig(
        edge_len=cfg.model.grid.edge_len, grid_size=cfg.eval.eval_grid_size,
        max_anchors=cfg.eval.eval_max_anchors))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = FusedSceneInference._grid_from_extent(fake, np.array(extent))
    assert scene_grid(extent) == tuple(want.grid_size)
