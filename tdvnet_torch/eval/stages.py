"""Named stages of 3D evaluation: `eval_load`, `eval_predict`, `eval_2d`,
`eval_mask_raster`, `eval_pc_fusion`, `eval_downsample_kdtree`,
`eval_tsdf`, `eval_marching` and `eval_write`.

Each stage is a `torch.profiler.record_function` range of its name (a
trace shows its host and device time; the range costs nothing when no
profiler runs) and, when the caller passes a `timings` dict, adds its host
seconds there. A stage whose work runs on the device ends in a copy to the
host, so its host seconds include the device's.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Optional

import torch

_lock = threading.Lock()     # the loader and metrics threads share a dict


@contextlib.contextmanager
def stage(name: str, timings: Optional[Dict[str, float]] = None):
    with torch.profiler.record_function(name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if timings is not None:
                dt = time.perf_counter() - t0
                with _lock:
                    timings[name] = timings.get(name, 0.0) + dt
