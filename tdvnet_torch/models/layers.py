"""Shared conv blocks (NCHW / NCDHW inside), BatchNorm with flax's
training rules and masked GroupNorm (port of `tdvnet/models/layers.py`).

Submodule names mirror the flax parameter tree (`Conv_0`, `BatchNorm_0`,
...), so each checkpoint key maps one to one onto a state-dict key.

The compute dtype: the convolutions and linear layers here (`Conv1d`,
`Conv2d`, `Conv3d`, `Linear`, the up-conv) compute in their
`compute_dtype` once `set_compute_dtype` has set it (bf16 inference), their
input and their fp32 parameters cast at use, as flax's `dtype` with an fp32
`param_dtype` does; None, the default, leaves each as torch's (fp32, or
float64 in a float64 reference run). torch's BatchNorm in eval mode takes a
bf16 input with its fp32 parameters and statistics, computes in fp32 and
rounds once, as flax's BatchNorm(dtype=bf16) does; in train mode the batch
statistics and the normalisation of a bf16 input are fp32 too, rounded
once to bf16, as there.

Inside `recompute_mode()` (the backward's rerun of a rematerialised
forward, `train/loop.py`) a train-mode BatchNorm normalises as it did but
leaves its running statistics alone: the first run moved them.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tdvnet_torch.kernels.groupnorm import masked_group_norm


class _Cast:
    """A layer with a compute dtype (None: torch's own behaviour).

    A layer whose output is the logits of an fp32 softmax (`logits_fp32`:
    the cost volume's last conv, the hypothesis decoder's) keeps that output
    in fp32 in a bf16 model: its bf16 inputs and cast parameters are widened
    exactly and the conv runs in fp32, so the output is the bf16 conv's sum
    unrounded. A logit near 30 has a bf16 ulp of 0.125, which moves its
    softmax weight by ~13%; the JAX package's bf16 model on the CPU keeps
    these logits unrounded too (XLA's excess precision), and rounding them
    put the port's gradient norms of the cost regulariser and the decoder
    at 1.58x and 2.51x JAX's own bf16 error on an H100 (against 0.99x and
    1.45x kept in fp32)."""

    compute_dtype: Optional[torch.dtype] = None
    logits_fp32: bool = False

    def cast(self, x):
        """(x, weight, bias) in the compute dtype, or as they are."""
        dt = self.compute_dtype
        if dt is None:
            return x, self.weight, self.bias
        b = self.bias
        out = (x.to(dt), self.weight.to(dt), None if b is None else b.to(dt))
        if self.logits_fp32:
            return tuple(None if t is None else t.float() for t in out)
        return out


class Conv1d(_Cast, nn.Conv1d):
    def forward(self, x):
        return self._conv_forward(*self.cast(x))


class Conv2d(_Cast, nn.Conv2d):
    def forward(self, x):
        return self._conv_forward(*self.cast(x))


class Conv3d(_Cast, nn.Conv3d):
    def forward(self, x):
        return self._conv_forward(*self.cast(x))


class Linear(_Cast, nn.Linear):
    def forward(self, x):
        return F.linear(*self.cast(x))


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> None:
    """Every layer of `module` that has a compute dtype computes in `dtype`
    (fp32: torch's own behaviour)."""
    dt = None if dtype == torch.float32 else dtype
    for m in module.modules():
        if isinstance(m, _Cast):
            m.compute_dtype = dt


_CONV = {1: Conv1d, 2: Conv2d, 3: Conv3d}

# reruns of a rematerialised forward in progress (`recompute_mode`)
_RECOMPUTING = [0]


@contextlib.contextmanager
def recompute_mode():
    """Inside the block a train-mode BatchNorm does not move its running
    statistics."""
    _RECOMPUTING[0] += 1
    try:
        yield
    finally:
        _RECOMPUTING[0] -= 1


class _FlaxBatchNorm:
    """BatchNorm with flax's train-mode rules. The output normalises with
    the batch mean and the biased batch variance, as torch's does, but the
    running variance averages the biased variance too (torch averages the
    unbiased one). The running statistics move by `momentum` (torch's
    0.1 is flax's 0.9, the weight of the old statistic). In eval mode it is
    torch's BatchNorm. In train mode it is torch's native kernel (on the
    CPU the same as `F.batch_norm`), never cuDNN's: cuDNN's train-mode
    backward sums its terms in fp32 where they cancel, which put the
    gradients behind the decoder ~1e-3 off a float64 rerun on an H100.
    A bf16 x is widened: the statistics and the normalisation run in fp32
    and the output is rounded once to bf16, as flax's BatchNorm(dtype=bf16)
    computes."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        self._check_input_dim(x)
        xw = x.to(torch.promote_types(x.dtype, torch.float32))
        y = torch.native_batch_norm(xw, self.weight, self.bias, None, None,
                                    True, 0.0, self.eps)[0].to(x.dtype)
        if _RECOMPUTING[0]:
            return y
        with torch.no_grad():
            dims = [0, *range(2, x.dim())]
            var, mean = torch.var_mean(xw, dim=dims, unbiased=False)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return y


class BatchNorm1d(_FlaxBatchNorm, nn.BatchNorm1d):
    pass


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    pass


class BatchNorm3d(_FlaxBatchNorm, nn.BatchNorm3d):
    pass


_BN = {1: BatchNorm1d, 2: BatchNorm2d, 3: BatchNorm3d}


def batch_norm(nd: int, features: int) -> nn.Module:
    return _BN[nd](features, eps=1e-5, momentum=0.1)


def same_pads(in_sizes: Sequence[int], kernel: Sequence[int],
              strides: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """XLA 'SAME' padding (lo, hi) per spatial dim."""
    out = []
    for i, k, s in zip(in_sizes, kernel, strides):
        o = -(-i // s)
        total = max((o - 1) * s + k - i, 0)
        out.append((total // 2, total - total // 2))
    return tuple(out)


class ConvBnRelu(nn.Module):
    """Conv (no bias) + BatchNorm + ReLU, 2D or 3D. Pads k//2 on both sides
    at every stride, as torch does and as the JAX package does explicitly."""

    def __init__(self, in_ch: int, features: int, kernel_size=(3, 3),
                 strides=None):
        super().__init__()
        nd = len(kernel_size)
        strides = strides or (1,) * nd
        self.Conv_0 = _CONV[nd](in_ch, features, tuple(kernel_size),
                                stride=tuple(strides),
                                padding=tuple(k // 2 for k in kernel_size),
                                bias=False)
        self.BatchNorm_0 = batch_norm(nd, features)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


# out[2m] = x[m] w[1] and out[2m + 1] = x[m] w[2] + x[m + 1] w[0] along each
# dim of the stride-2 transposed conv (padding 1, output_padding 1): the tap
# of the 3-wide kernel at offset a of a 2-wide window for an output of
# parity p is _UP_TAP[p][a] (-1: none)
_UP_TAP = ((1, -1), (2, 0))
_UP_INDEX = {}


def _up_index(device):
    """[8, 2, 2, 2]: for each output parity (pd, ph, pw) and window offset,
    the flat tap of the 3x3x3 kernel, or 27 for a zero."""
    if device not in _UP_INDEX:
        def tap(p, o):
            t = [_UP_TAP[pi][oi] for pi, oi in zip(p, o)]
            return 27 if -1 in t else t[0] * 9 + t[1] * 3 + t[2]

        bits = [(i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1)]
        _UP_INDEX[device] = torch.tensor(
            [[tap(p, o) for o in bits] for p in bits],
            device=device).view(8, 2, 2, 2)
    return _UP_INDEX[device]


def _up_conv_polyphase(x, w):
    """`conv_transpose3d(x, w, stride=2, padding=1, output_padding=1)` as
    one plain conv with a 2x2x2 kernel and eight output channels per
    channel, one per parity of the output's (d, h, w), each holding the
    taps that reach it and zeros (exact) elsewhere; then interleaved.
    A plain conv sums in a fixed order."""
    B, Ci, D, H, W = x.shape
    Co = w.shape[1]
    wz = torch.cat([w.reshape(Ci, Co, 27), w.new_zeros(Ci, Co, 1)], 2)
    k = wz[:, :, _up_index(w.device)]               # [Ci, Co, 8, 2, 2, 2]
    k = k.permute(2, 1, 0, 3, 4, 5).reshape(8 * Co, Ci, 2, 2, 2)
    y = F.conv3d(F.pad(x, (0, 1, 0, 1, 0, 1)), k)   # [B, 8 Co, D, H, W]
    y = y.view(B, 2, 2, 2, Co, D, H, W).permute(0, 4, 5, 1, 6, 2, 7, 3)
    return y.reshape(B, Co, 2 * D, 2 * H, 2 * W)


class _UpConvFunction(torch.autograd.Function):
    """The polyphase forward; the backward is the transposed conv's own
    (cuDNN's, on the card), which does 27/64 of the work of the plain
    conv's backward (no zero taps)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _up_conv_polyphase(x, w)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gx, gw, _ = torch.ops.aten.convolution_backward(
            gy.contiguous(), x, w, None, [2] * 3, [1] * 3, [1] * 3, True,
            [1] * 3, 1, [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                         False])
        return gx, gw


class _RepeatableConvTranspose3d(_Cast, nn.ConvTranspose3d):
    """The stride-2 up-conv with a forward that repeats bit for bit.
    cuDNN's default pick for the cost regularisation's last up-conv and the
    scene U-Net's sums in a run-dependent order: the initial depth then
    moves from run to run, and at n_iters >= 1 the PointNet's max pools
    route that noise onto other rows (the n_iters=2 train loss moved 7e-6
    to 7e-5 off a float64 rerun from run to run on an H100). cuDNN's
    deterministic picks took up to 14x the default's forward time there,
    the polyphase conv 0.35x to 1.9x (`tools/probe_up_conv.py`, H100 80GB
    HBM3 at 700 W)."""

    def forward(self, x, output_size=None):
        if output_size is not None:
            raise ValueError("the up-conv's output size is fixed: 2x")
        x, w, _ = self.cast(x)
        return _UpConvFunction.apply(x, w)


def up_conv3d(in_ch: int, features: int):
    """The JAX package's input-dilated conv (lhs dilation 2, padding (1, 2),
    kernel 3): a stride-2 transposed conv with output_padding 1. The
    checkpoint's kernel is flipped and transposed into this layout."""
    return _RepeatableConvTranspose3d(in_ch, features, 3, stride=2,
                                      padding=1, output_padding=1,
                                      bias=False)


class ConvTransposeUp3d(nn.Module):
    """Stride-2 3D transposed conv x2 upsampling + BN + ReLU."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.Conv_0 = up_conv3d(in_ch, features)
        self.BatchNorm_0 = batch_norm(3, features)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


class MaskedGroupNorm(nn.Module):
    """Masked GroupNorm with an affine (the `masked_group_norm` kernel);
    `weight`/`bias` are the flax `scale`/`bias`. `relu` and `skip` select
    the kernel's fused tails `relu(y) * mask` and `relu(y + skip) * mask`."""

    def __init__(self, num_groups: int, features: int):
        super().__init__()
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, mask, relu: bool = False, skip=None):
        return masked_group_norm(x, mask, self.num_groups, self.weight,
                                 self.bias, relu=relu, skip=skip)


def downsample_mask(mask: torch.Tensor) -> torch.Tensor:
    """2x max-pool of a [B, 1, gx, gy, gz] occupancy mask: the active set of
    a stride-2 sparse conv."""
    return F.max_pool3d(mask, 2, 2)
