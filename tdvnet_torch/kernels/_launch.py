"""Argument checks and the launch call shared by the kernel wrappers."""
from __future__ import annotations

import torch


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the wrapper then runs its
    plain twin); False when all lie on one CUDA device. Anything else
    raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(f"tensors must all be on the CPU or on one CUDA device, "
                     f"got {[str(t.device) for t in tensors]}")


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None,
          contiguous: bool = True) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None:
        if t.dim() != len(shape) or any(
                s is not None and s != d for s, d in zip(shape, t.shape)):
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def launch(fn_name: str, device: torch.device, *args) -> None:
    """Call one C entry point of the kernel library on `device`'s current
    stream and raise if the launch was refused."""
    from tdvnet_torch.kernels.build import library

    fn = getattr(library(), fn_name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err} at launch")
