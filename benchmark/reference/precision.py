"""The precision the reference computes its products in.

``F32`` is the reference: float32 operands, TF32 off (``no_tf32``).
``FP8`` is the control of the benchmark's check: the same reference with
every operand of every product (linear layers, convolutions, the two
attention einsums) rounded to float8 e4m3 with a per-tensor scale (amax
to 448, as fp8 inference scales a tensor), and in training every
gradient that leaves a product toward an operand rounded to float8 e5m2
(amax to 57344), as fp8 training keeps its gradients; the products
themselves accumulate in float32. ``BF16`` rounds the same operands and
gradients to bfloat16: the precision the configurations state, used to
tell rounding from a fault when the program's readings are read.
Norms, softmax, activations and the LSTM's cell stay float32.
"""
from __future__ import annotations

import contextlib

import torch


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    if dtype is None:
        return x
    if top is None:
        return x.to(dtype).float()
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).float() * scale


class _Rounded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, prec):
        ctx.prec = prec
        return _round(x, prec.fwd, prec.fwd_top)

    @staticmethod
    def backward(ctx, g):
        p = ctx.prec
        return _round(g, p.bwd, p.bwd_top), None


class Precision:
    FORMATS = {"f32": (None, None, None, None),
               "bf16": (torch.bfloat16, None, torch.bfloat16, None),
               "fp8": (torch.float8_e4m3fn, 448.0, torch.float8_e5m2,
                       57344.0)}

    def __init__(self, name: str):
        if name not in self.FORMATS:
            raise ValueError(f"unknown reference precision {name!r}")
        self.name = name
        self.fwd, self.fwd_top, self.bwd, self.bwd_top = self.FORMATS[name]

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product, as this precision holds it."""
        if self.fwd is None:
            return x
        return _Rounded.apply(x, self)


F32 = Precision("f32")
BF16 = Precision("bf16")
FP8 = Precision("fp8")


@contextlib.contextmanager
def no_tf32():
    """Float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd
