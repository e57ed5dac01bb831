"""tdvnet_torch: the PyTorch and CUDA port of tdvnet for one NVIDIA H100.

It imports torch and numpy only, never JAX or the `tdvnet` package, which
stays the reference every ported part is tested against. Entry points run
on the card unless the caller names another device; the hand-written CUDA
kernels (`tdvnet_torch.kernels`) build at first use.
"""
