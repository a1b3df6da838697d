"""Precision of the reference and of its control.

The reference runs in float32 with TF32 off (:func:`exact_fp32`). Its
control, the reference in the next precision below the configurations'
bfloat16, runs every conv on fp8 (e4m3) inputs and weights, each tensor
scaled by its own absolute maximum as an fp8 GEMM scales it
(:func:`fp8_e4m3`)."""

import contextlib

import torch

FP8_MAX = 448.0  # largest finite float8_e4m3fn


@contextlib.contextmanager
def exact_fp32():
    """float32 matrix products and convs without TF32 inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fp8_e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8_e4m3fn under a per-tensor scale, back in
    ``t``'s dtype."""
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    scale = FP8_MAX / amax
    q = ((t.float() * scale).to(torch.float8_e4m3fn).float() / scale
         ).to(t.dtype)
    # Straight through: the forward sees the rounded value, the gradient
    # passes unchanged, as in quantisation-aware training.
    return t + (q - t).detach()


QUANT = {None: None, "fp8": fp8_e4m3}
