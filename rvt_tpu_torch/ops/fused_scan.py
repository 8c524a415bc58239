"""Whole-window backbone stage on hand-written Hopper kernels.

Port of ``rvt_tpu/ops/fused_scan.py`` and ``rvt_tpu/ops/fused_lstm.py``.
On the TPU ``fused_stage_scan`` is one Pallas kernel per stage whose
sequential grid runs the time loop with the LSTM carry in VMEM. On Hopper
blocks run in parallel and in no order, so the stage is split where the
recurrence allows it: the attention pair has none and runs over all T*B
frames at once (``fused_attention_pair``: kernels K1-K3), and only the
ConvLSTM scans, as kernel K4 ``lstm_scan`` with the time loop inside the
block and the (h, c) carry in shared memory.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from rvt_tpu_torch.ops import kernels
from rvt_tpu_torch.ops.fused_attention import fused_attention_pair
from rvt_tpu_torch.ops.kernels import (Counter, check, check_operands, need,
                                       ptr, stream_ptr)

LSTM_SCAN = Counter("lstm_scan")


def lstm_scan_plain(x_seq: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    h0: torch.Tensor, c0: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The cell of ``_lstm_scan_kernel`` step by step: [x, h] in bf16 times
    W with f32 accumulation, rounded to bf16, + b in bf16; sigmoid gates
    and tanh cell input rounded to bf16; c and h in f32."""
    C = h0.shape[-1]
    wf = w.float()
    bias = b.float().reshape(-1)
    h, c = h0.float(), c0.float()
    hs = []
    for t in range(x_seq.shape[0]):
        xh = torch.cat([x_seq[t].to(torch.bfloat16), h.to(torch.bfloat16)],
                       dim=-1).float()
        mix = (xh @ wf).to(torch.bfloat16)
        mix = (mix.float() + bias).to(torch.bfloat16).float()
        gates = torch.sigmoid(mix[..., :3 * C]).to(torch.bfloat16).float()
        cell_input = torch.tanh(mix[..., 3 * C:]).to(torch.bfloat16).float()
        c = gates[..., :C] * c + gates[..., C:2 * C] * cell_input
        h = gates[..., 2 * C:] * torch.tanh(c)
        hs.append(h.to(torch.bfloat16))
    return torch.stack(hs), h, c


def fused_lstm_scan(x_seq: torch.Tensor, lstm_w: torch.Tensor,
                    lstm_b: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                    *, plain: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scan the ConvLSTM cell over a [T, B, H, W, C] window (bf16 or f32
    input; the kernel rounds f32 to bf16 on load). lstm_w [2C, 4C] bf16,
    lstm_b [4C] bf16, h0/c0 [B, H, W, C] f32. Returns (h_seq bf16, h_T f32,
    c_T f32)."""
    if plain or not x_seq.is_cuda:
        return lstm_scan_plain(x_seq, lstm_w, lstm_b, h0, c0)
    T, B, H, W, C = x_seq.shape
    b = lstm_b.reshape(-1)
    h0, c0 = h0.float().contiguous(), c0.float().contiguous()
    check_operands("lstm_scan", x_seq, lstm_w, b, h0, c0)
    need(x_seq.dtype in (torch.float32, torch.bfloat16)
         and lstm_w.dtype == b.dtype == torch.bfloat16
         and tuple(lstm_w.shape) == (2 * C, 4 * C) and b.numel() == 4 * C
         and tuple(h0.shape) == (B, H, W, C) == tuple(c0.shape)
         and C % 16 == 0 and (C < 64 or C % 64 == 0)
         and lstm_w.data_ptr() % 32 == 0,
         "lstm_scan: x [T, B, H, W, C] f32/bf16, w [2C, 4C] bf16, "
         "b [4C] bf16, h0/c0 [B, H, W, C] f32; C % 16 == 0 and C < 64 "
         "or C % 64 == 0")
    h_seq = torch.empty(x_seq.shape, dtype=torch.bfloat16,
                        device=x_seq.device)
    hT = torch.empty_like(h0)
    cT = torch.empty_like(c0)
    err = kernels.lib("lstm_scan").rvt_lstm_scan(
        ptr(x_seq), int(x_seq.dtype == torch.float32), ptr(lstm_w),
        ptr(b), ptr(h0), ptr(c0), ptr(h_seq), ptr(hT), ptr(cT),
        T, B, H * W, C, stream_ptr(x_seq))
    check(err, "lstm_scan")
    LSTM_SCAN.launches += 1
    return h_seq, hT, cT


def fused_conv_lstm(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                    w: torch.Tensor, b: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ConvLSTM step (``rvt_tpu/ops/fused_lstm.py:fused_conv_lstm``):
    ``fused_lstm_scan`` at T = 1. Returns (h_t, c_t) f32."""
    _, hT, cT = fused_lstm_scan(x.unsqueeze(0).contiguous(), w, b, h, c)
    return hT, cT


def fused_stage_scan(x_seq: torch.Tensor,
                     params_window: Dict[str, torch.Tensor],
                     params_grid: Dict[str, torch.Tensor],
                     lstm_w: torch.Tensor, lstm_b: torch.Tensor,
                     h0: torch.Tensor, c0: torch.Tensor, *, heads: int,
                     dim_head: int, part: Tuple[int, int], eps: float,
                     ds_ln_params: Sequence[torch.Tensor] = (),
                     ds_eps: float = 1e-5, plain: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One backbone stage over a whole [T, B, H, W, C] window: the attention
    pair over all T*B frames (K1-K3), then the LSTM scan (K4) on its f32
    residual output. With ``ds_ln_params`` = (scale, bias) x_seq is the raw
    downsample-conv output and its LayerNorm runs first; otherwise x_seq
    must be bf16 and already normed. Returns (h_seq [T, B, H, W, C] bf16,
    h_T f32, c_T f32), as the TPU kernel does."""
    T, B, H, W, C = x_seq.shape
    R = fused_attention_pair(
        x_seq.reshape(T * B, H, W, C), params_window, params_grid,
        heads=heads, dim_head=dim_head, part=part, skip_first_norm=True,
        eps=eps, ds_ln_params=ds_ln_params, ds_eps=ds_eps, plain=plain)
    return fused_lstm_scan(R.view(T, B, H, W, C), lstm_w, lstm_b, h0, c0,
                           plain=plain)


def fused_stage(x: torch.Tensor, params_window: Dict[str, torch.Tensor],
                params_grid: Dict[str, torch.Tensor], lstm_w: torch.Tensor,
                lstm_b: torch.Tensor, h: torch.Tensor, c: torch.Tensor, *,
                heads: int, dim_head: int, part: Tuple[int, int], eps: float,
                ds_ln_params: Sequence[torch.Tensor] = (),
                ds_eps: float = 1e-5, plain: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One backbone stage for one time step
    (``rvt_tpu/ops/fused_attention.py:fused_stage``): the attention pair
    over the B frames x [B, H, W, C] (K1-K3), then the ConvLSTM cell (K4 at
    T = 1) from (h, c) f32. x is bf16 and layer-normed, or the raw
    downsample-conv output with ``ds_ln_params``, as in
    ``fused_stage_scan``. Returns (h_t, c_t) f32."""
    _, h_t, c_t = fused_stage_scan(
        x.unsqueeze(0), params_window, params_grid, lstm_w, lstm_b, h, c,
        heads=heads, dim_head=dim_head, part=part, eps=eps,
        ds_ln_params=ds_ln_params, ds_eps=ds_eps, plain=plain)
    return h_t, c_t


# The JAX package's 'split' serving mode (pair over T*B frames, then the
# LSTM scan) is the only composition on Hopper.
split_stage_scan = fused_stage_scan
