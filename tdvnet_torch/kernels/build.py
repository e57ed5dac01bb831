"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` file is compiled by its own `nvcc` process (all started
together) for `sm_90a`, and the objects are linked into one shared library
with a plain C interface, loaded through ctypes. The `*.cuh` headers they
include count in the hash of the sources. The library goes under
`build/tdvnet_torch/<hash of the sources>/` beside the package, at first
use; a second process that finds it there loads it as it is. Nothing is
built when the package is imported.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "tdvnet_torch")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
LIB_NAME = "libtdvnet_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C entry points and their argument types (pointers and the stream are
# c_void_p: ctypes would otherwise pass them as 32-bit ints)
SIGNATURES = {
    "tdv_source_variance": [_P] * 7 + [_I, _L, _I, _I, _I, _I, _F, _F, _P],
    "tdv_source_variance_backward": [_P] * 10 + [_I, _L, _I, _I, _I, _I, _I,
                                                 _L, _L, _F, _F, _P],
    "tdv_trilinear_sample": [_P, _P, _P, _P, _I, _L, _I, _I, _I, _I, _F, _I,
                             _I, _P],
    "tdv_trilinear_sample_i8": [_P, _P, _P, _P, _P, _I, _L, _I, _I, _I, _I,
                                _F, _F, _I, _I, _P],
    "tdv_patch_fan_variance": [_P, _P, _P, _P, _P, _P, _I, _I, _L, _I, _I,
                               _I, _I, _F, _F, _P],
    "tdv_propagation_blend": [_P, _P, _P, _I, _I, _I, _L, _L, _L, _L, _P],
    "tdv_softargmax_depth": [_P, _P, _P, _I, _I, _L, _P],
    "tdv_softargmax_depth_max_planes": [],
    "tdv_softargmax_depth_long": [_P, _P, _P, _I, _I, _L, _P],
    "tdv_softargmax_depth_backward": [_P] * 5 + [_I, _I, _L, _P],
    "tdv_softargmax_depth_backward_long": [_P] * 5 + [_I, _I, _L, _P],
    "tdv_propagation_blend_backward": [_P] * 6 + [_I] * 3 + [_L] * 8 + [_P],
    "tdv_batched_dot": [_P] * 3 + [_L, _I, _I, _I, _P],
    "tdv_take_along_axis": [_P] * 3 + [_I] * 6 + [_P],
    "tdv_scene_origins": [_P, _P, _P, _P, _P, _L, _I, _P],
    "tdv_voxelize": [_P] * 14 + [_L, _I, _I, _I, _I, _F, _I, _P],
    "tdv_scatter_dense": [_P] * 7 + [_I] * 6 + [_P],
    "tdv_segment_plan": [_P] * 7 + [_I, _I, _I, _I, _P],
    "tdv_segment_plan_floor": [_I, _I, _I, _P],
    "tdv_segment_max": [_P] * 8 + [_I, _I, _I, _I, _P],
    "tdv_gather_concat": [_P, _P, _P, _P, _L, _I, _L, _I, _P],
    "tdv_masked_group_norm": [_P] * 9 + [_I, _I, _I, _L, _F, _I, _L, _I,
                                         _P],
    "tdv_tsdf_integrate": [_P, _P, _I] + [_P] * 9 + [_I] * 6 + [_F] * 5
    + [_P],
    "tdv_consistency_fuse": [_P] * 10 + [_I] * 4 + [_F, _I, _P],
    "tdv_scatter_dense_backward": [_P] * 5 + [_I] * 5 + [_P],
    "tdv_segment_max_backward": [_P] * 7 + [_L, _I, _L, _P],
    "tdv_gather_concat_backward": [_P] * 8 + [_L, _I, _L, _I, _P],
    "tdv_masked_group_norm_backward": [_P] * 16 + [_I, _I, _I, _L, _I, _I,
                                                   _L, _I, _P],
    "tdv_masked_group_norm_backward_shape": [_I, _I, _I, _L, _P],
    "tdv_trilinear_sample_backward": [_P] * 7 + [_I, _L, _I, _I, _I, _I, _F,
                                                 _P],
}
# the bf16 forms take the fp32 entry points' arguments (the variance's
# `half_out` flag where the fp32 form has its mean pointer)
SIGNATURES.update({
    "tdv_source_variance_bf16": [_P] * 7 + [_I, _I, _L, _I, _I, _I, _I, _F,
                                            _F, _P],
    "tdv_masked_group_norm_backward_shape_bf16":
        SIGNATURES["tdv_masked_group_norm_backward_shape"],
    # the first argument says whether the grad is bf16 (else fp32)
    "tdv_source_variance_backward_bf16":
        [_I] + SIGNATURES["tdv_source_variance_backward"],
    **{name + "_bf16": SIGNATURES[name] for name in (
        "tdv_trilinear_sample", "tdv_scatter_dense", "tdv_segment_max",
        "tdv_gather_concat", "tdv_masked_group_norm",
        "tdv_scatter_dense_backward", "tdv_segment_max_backward",
        "tdv_gather_concat_backward", "tdv_masked_group_norm_backward",
        "tdv_trilinear_sample_backward")},
})


class BuildError(RuntimeError):
    pass


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise BuildError("nvcc not found (PATH and /usr/local/cuda/bin)")
    return path


def _source_hash() -> str:
    h = hashlib.sha256(ARCH.encode())
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    for src in sources() + headers:
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


class BuildInfo:
    """What a build did: its seconds and the ptxas resource summary."""

    def __init__(self, lib_path: str, seconds: float, ptxas: str,
                 built: bool):
        self.lib_path = lib_path
        self.seconds = seconds
        self.ptxas = ptxas
        self.built = built


def build() -> BuildInfo:
    """Compile the sources into the shared library unless it exists."""
    out_dir = os.path.join(BUILD_ROOT, _source_hash())
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        return BuildInfo(lib_path, 0.0, "", False)
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in sources():
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-c", src, "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, objs = [], []
        for src, obj, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                for _, _, other in procs:
                    other.kill()
                raise BuildError(f"nvcc failed on {src}:\n{out}")
            logs.append(out)
            objs.append(obj)
        tmp_lib = os.path.join(tmp, LIB_NAME)
        link = subprocess.run([nvcc, ARCH, "-shared", "-o", tmp_lib, *objs],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise BuildError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)       # atomic: readers see all or none
    return BuildInfo(lib_path, time.perf_counter() - t0, "".join(logs), True)


@functools.lru_cache(maxsize=None)
def library():
    """The loaded kernel library (built first if needed), plus its
    BuildInfo as `library().build_info`."""
    info = build()
    lib = ctypes.CDLL(info.lib_path)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.build_info = info
    return lib
