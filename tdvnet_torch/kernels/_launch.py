"""Argument checks, the launch call and the twins' working type, shared by
the kernel wrappers."""
from __future__ import annotations

import torch


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the wrapper then runs its
    plain twin); False when all lie on one CUDA device. Anything else
    raises."""
    # the common case first, without building a device object per tensor
    index = tensors[0].get_device()
    if index >= 0 and all(t.is_cuda and t.get_device() == index
                          for t in tensors):
        return False
    first = tensors[0].device
    if all(t.device == first for t in tensors[1:]):
        if first.type == "cpu":
            return True
        if first.type == "cuda":
            return False
    raise ValueError(f"tensors must all be on the CPU or on one CUDA device, "
                     f"got {[str(t.device) for t in tensors]}")


def wants_grad(*tensors) -> bool:
    """True when autograd records this call: grad mode is on and a tensor
    (None skipped) requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def no_backward(kernel: str, *tensors) -> None:
    """Raise for a kernel without a backward when autograd would record the
    call. The C launch returns a tensor without a `grad_fn`, so training
    through it would drop the gradient without a word."""
    if wants_grad(*tensors):
        raise NotImplementedError(
            f"{kernel}: backward not ported yet (an input requires grad); "
            f"run under torch.no_grad() or torch.inference_mode(), or on "
            f"CPU tensors, where the plain twin is differentiable")


def at_least_fp32(x: torch.Tensor) -> torch.Tensor:
    """A twin's working type: the JAX package widens a bf16 compute dtype to
    fp32; a float64 input (a float64 reference run) stays float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def quad(C: int) -> int:
    """C rounded up to a whole number of the kernels' 4-channel groups."""
    return -(-C // 4) * 4


def pad_channels(x: torch.Tensor, width: int) -> torch.Tensor:
    """x with zero channels added on its last axis up to `width` (x itself
    where it is that wide already). The kernels that read and write float4
    channel groups take any C this way: each channel's arithmetic is its
    own, so the real channels of the padded call are the bits an exact-width
    call would give, and the wrapper slices them out."""
    C = x.shape[-1]
    if C == width:
        return x
    out = x.new_zeros((*x.shape[:-1], width))
    out[..., :C] = x
    return out


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None,
          contiguous: bool = True) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    # the exact shape first: the wrappers' host path is a small kernel's
    # whole time; a shape with None wildcards takes the long test
    if shape is not None and t.shape != shape:
        if t.dim() != len(shape) or any(
                s is not None and s != d for s, d in zip(shape, t.shape)):
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


_ENTRY_POINTS = {}       # C entry points of the kernel library, by name


def launch(fn_name: str, device: torch.device, *args) -> None:
    """Call one C entry point of the kernel library on `device`'s current
    stream and raise if the launch was refused. At the probes' sizes this
    host path is a call's whole time, so it stays short: the raw stream
    handle, and a device switch only when `device` is not the current
    one."""
    fn = _ENTRY_POINTS.get(fn_name)
    if fn is None:
        from tdvnet_torch.kernels.build import library

        fn = _ENTRY_POINTS[fn_name] = getattr(library(), fn_name)
    index = device.index
    current = torch._C._cuda_getDevice()    # CUDA is up: a tensor is there
    if index is None or index == current:
        err = fn(*args, torch._C._cuda_getCurrentRawStream(current))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err} at launch")
