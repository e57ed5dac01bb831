"""Keyframe selection policies over camera-pose sequences (numpy copy of
`tdvnet/data/frameselector.py`, the same RNG use).

Behavior-parity rewrite of the reference's five selectors
(`mv3d/dsets/frameselector.py:12-177`), built around one vectorized
pose-distance primitive instead of per-frame python loops.

Pose distance between cam→world poses A, B (reference `frameselector.py:43`):
    d = sqrt(||t_rel||^2 + (2/3) * tr(I - R_rel)),  P_rel = A^-1 B
"""
from __future__ import annotations

import numpy as np


def pose_distances(ref_pose: np.ndarray, poses: np.ndarray) -> np.ndarray:
    """Distance from one reference pose to a stack of poses.

    ref_pose: [4,4]; poses: [M,4,4].  Returns [M] float.
    """
    P_rel = np.linalg.inv(ref_pose)[None] @ poses
    t_sq = np.sum(P_rel[:, :3, 3] ** 2, axis=-1)
    tr = np.trace(P_rel[:, :3, :3], axis1=-2, axis2=-1)
    return np.sqrt(np.maximum(t_sq + (2.0 / 3.0) * (3.0 - tr), 0.0))


class FrameSelector:
    def select_frames(self, poses: np.ndarray, n_frames: int,
                      seed_idx=None) -> np.ndarray:
        raise NotImplementedError


def _seed(n_total: int, n_frames: int, interval: int, seed_idx, rng) -> int:
    max_idx = n_total - n_frames * interval - 1
    if seed_idx is not None:
        return int(seed_idx)
    return 0 if max_idx <= 0 else int(rng.integers(0, max_idx))


class RangePoseDistSelector(FrameSelector):
    """Walk forward choosing a random frame whose pose-dist lies in a range
    (training selector, reference `frameselector.py:12-54`)."""

    def __init__(self, p_min: float, p_max: float, search_interval: int,
                 rng: np.random.Generator | None = None):
        self.p_min, self.p_max = p_min, p_max
        self.p_opt = p_min + (p_max - p_min) / 2.0
        self.search_interval = search_interval
        self.rng = rng or np.random.default_rng()

    def select_frames(self, poses, n_frames, seed_idx=None):
        n_total = poses.shape[0]
        idx = [_seed(n_total, n_frames, self.search_interval, seed_idx, self.rng)]
        for _ in range(n_frames - 1):
            lo = idx[-1] + 1
            hi = min(lo + self.search_interval, n_total)
            if hi <= lo:
                break
            d = pose_distances(poses[idx[-1]], poses[lo:hi])
            ok = (d > self.p_min) & (d < self.p_max)
            if ok.any():
                choice = int(self.rng.choice(np.flatnonzero(ok)))
            else:
                choice = int(np.argmin(np.abs(d - self.p_opt)))
            idx.append(lo + choice)
        return np.asarray(idx)


class BestPoseDistSelector(FrameSelector):
    """Walk forward to the frame closest to an optimal pose-dist
    (validation selector, reference `frameselector.py:57-93`)."""

    def __init__(self, p_opt: float, search_interval: int,
                 rng: np.random.Generator | None = None):
        self.p_opt = p_opt
        self.search_interval = search_interval
        self.rng = rng or np.random.default_rng()

    def select_frames(self, poses, n_frames, seed_idx=None):
        n_total = poses.shape[0]
        idx = [_seed(n_total, n_frames, self.search_interval, seed_idx, self.rng)]
        for _ in range(n_frames - 1):
            lo = idx[-1] + 1
            hi = min(lo + self.search_interval, n_total)
            if hi <= lo:
                break
            d = pose_distances(poses[idx[-1]], poses[lo:hi])
            idx.append(lo + int(np.argmin(np.abs(d - self.p_opt))))
        return np.asarray(idx)


class NextPoseDistSelector(FrameSelector):
    """Advance to the first frame whose pose-dist exceeds a threshold
    (eval keyframing, reference `frameselector.py:96-133`).  The walk is
    capped at `search_interval` steps per keyframe; running off the end of
    the sequence terminates selection."""

    def __init__(self, p_thresh: float, search_interval: int = 30,
                 rng: np.random.Generator | None = None):
        self.p_thresh = p_thresh
        self.search_interval = search_interval
        self.rng = rng or np.random.default_rng()

    def select_frames(self, poses, n_frames, seed_idx=None):
        n_total = poses.shape[0]
        idx = [_seed(n_total, n_frames, self.search_interval, seed_idx, self.rng)]
        for _ in range(n_frames - 1):
            lo = idx[-1] + 1
            hi = min(lo + self.search_interval, n_total)
            d = pose_distances(poses[idx[-1]], poses[lo:hi]) if hi > lo else np.empty(0)
            over = np.flatnonzero(d >= self.p_thresh)
            # first frame over threshold, else `search_interval` steps ahead
            cur = lo + (int(over[0]) if over.size else self.search_interval)
            if cur > n_total - 1:
                break
            idx.append(cur)
        return np.asarray(idx)


class NeuralReconSelector(FrameSelector):
    """Translation/rotation-threshold keyframing
    (reference `frameselector.py:136-155`)."""

    def __init__(self, tmin: float = 0.1, rmin_deg: float = 15.0):
        self.tmin = tmin
        self.rmin_deg = rmin_deg

    def select_frames(self, poses, n_frames, seed_idx=None):
        cos_max = np.cos(np.deg2rad(self.rmin_deg))
        inds = np.arange(len(poses))
        if seed_idx is not None:
            inds = np.roll(inds, seed_idx)
        out = [inds[0]]
        for i in inds[1:]:
            prev, cand = poses[out[-1]], poses[i]
            cos_t = float(np.sum(prev[:3, 2] * cand[:3, 2]))
            tdist = float(np.linalg.norm(prev[:3, 3] - cand[:3, 3]))
            if tdist > self.tmin or cos_t < cos_max:
                out.append(i)
        return np.asarray(out)


class EveryNthSelector(FrameSelector):
    """Uniform stride selection (reference `frameselector.py:158-177`)."""

    def __init__(self, interval: int, rng: np.random.Generator | None = None):
        self.interval = interval
        self.rng = rng or np.random.default_rng()

    def select_frames(self, poses, n_frames, seed_idx=None):
        n_total = poses.shape[0]
        s = _seed(n_total, n_frames, self.interval, seed_idx, self.rng)
        end = min(n_total, s + self.interval * (n_frames - 1) + 1)
        return np.arange(s, end, self.interval)
