"""Whole-window backbone stage on hand-written Hopper kernels.

Port of ``rvt_tpu/ops/fused_scan.py`` and ``rvt_tpu/ops/fused_lstm.py``.
On the TPU ``fused_stage_scan`` is one Pallas kernel per stage whose
sequential grid runs the time loop with the LSTM carry in VMEM. On Hopper
blocks run in parallel and in no order, so the stage is split where the
recurrence allows it: the attention pair has none and runs over all T*B
frames at once (``fused_attention_pair``: kernels K1-K3), and only the
ConvLSTM scans, as kernel K4 ``lstm_scan`` with the time loop inside the
kernel and the (h, c) carry on chip; wider than 64 channels its input
product x.W_x for every step runs first as one K2 product, and only
h.W_h stays in the loop. For training K4 also writes the cell states
c_seq, and K8 ``lstm_scan_bwd`` runs the scan backwards with the (dh, dc)
carry (``ops/fused_train.py``).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from rvt_tpu_torch.ops import kernels
from rvt_tpu_torch.ops.fused_attention import (fused_attention_pair,
                                               gemm_bf16, gemm_bf16_wgrad,
                                               sum_parts)
from rvt_tpu_torch.ops.kernels import (Counter, check, check_operands, need,
                                       ptr, stream_ptr)

LSTM_SCAN = Counter("lstm_scan")
LSTM_SCAN_BWD = Counter("lstm_scan_bwd")
_PT = 32  # rows per K8 db partial: one partial row per 32-row tile


def _lstm_cell(xh: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               c_prev: torch.Tensor):
    """The cell as the JAX kernels recompute it (``fused_train.
    _lstm_recompute``): xh [..., 2C] of bf16 values, f32 sums rounded to
    bf16, + b in bf16; sigmoid gates and tanh cell input rounded to bf16;
    c and h in f32. Returns (f, i, o, g, c_t, h_t)."""
    C = c_prev.shape[-1]
    mix = (xh @ w.float()).to(torch.bfloat16)
    mix = (mix.float() + b.float().reshape(-1)).to(torch.bfloat16).float()
    gates = torch.sigmoid(mix[..., :3 * C]).to(torch.bfloat16).float()
    f, i, o = gates[..., :C], gates[..., C:2 * C], gates[..., 2 * C:]
    g = torch.tanh(mix[..., 3 * C:]).to(torch.bfloat16).float()
    c = f * c_prev + i * g
    return f, i, o, g, c, o * torch.tanh(c)


def _lstm_cell_bwd(f, i, o, g, c_prev, c_t, dh, dc):
    """The cell's backward (``fused_train._lstm_bwd_chunked``): returns
    (dmix [..., 4C] f32, dc_prev = dct * f)."""
    tc = torch.tanh(c_t)
    do = dh * tc
    dct = dc + dh * o * (1.0 - tc * tc)
    dmix = torch.cat([dct * c_prev * f * (1.0 - f),
                      dct * g * i * (1.0 - i),
                      do * o * (1.0 - o),
                      dct * i * (1.0 - g * g)], dim=-1)
    return dmix, dct * f


def lstm_scan_plain(x_seq: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    h0: torch.Tensor, c0: torch.Tensor,
                    with_c_seq: bool = False):
    """The cell of ``_lstm_scan_kernel`` step by step (``_lstm_cell``),
    h fed back as bf16. Returns (h_seq bf16, [c_seq f32,] h_T, c_T)."""
    h, c = h0.float(), c0.float()
    hs, cs = [], []
    for t in range(x_seq.shape[0]):
        xh = torch.cat([x_seq[t].to(torch.bfloat16), h.to(torch.bfloat16)],
                       dim=-1).float()
        *_, c, h = _lstm_cell(xh, w, b, c)
        hs.append(h.to(torch.bfloat16))
        cs.append(c)
    if with_c_seq:
        return torch.stack(hs), torch.stack(cs), h, c
    return torch.stack(hs), h, c


_FUSED_MAX_C = 64  # K4 keeps the whole W in one block up to this width
_HOIST_BYTES = 512 * 2 ** 20  # bound of the f32 x . W_x buffer per launch


def lstm_weights_t(lstm_w: torch.Tensor) -> torch.Tensor:
    """K4's weight layout: [2, 4C, C] = (W_x^T, W_h^T) of lstm_w [2C, 4C]
    (the serving step makes it once, the per-step train path once a
    window, the whole-window train step on every call)."""
    C = lstm_w.shape[0] // 2
    return lstm_w.reshape(2, C, 4 * C).transpose(1, 2).contiguous()


def _hoist_steps(T: int, rows: int, C: int) -> int:
    """Steps of x . W_x that one launch of the product computes: the f32
    [steps * rows, 4C] buffer stays within ``_HOIST_BYTES``."""
    return max(1, min(T, _HOIST_BYTES // (rows * 4 * C * 4)))


def lstm_scan_launches(T: int, rows: int, C: int) -> int:
    """Kernel launches of one ``fused_lstm_scan`` call over T steps of
    ``rows`` pixels: one fused K4 (C <= 64), else per chunk of steps the
    input product (K2's rt_f32, counted as K4's) and the recurrent K4."""
    if C <= _FUSED_MAX_C:
        return 1
    return 2 * -(-T // _hoist_steps(T, rows, C))


def lstm_scan_plan(T: int, rows: int, C: int, x_f32: bool = True) -> Dict:
    """The recurrent K4 launch's plan on this card (for reports): cluster
    size, rows per cluster, clusters, clusters resident at once, warps per
    block, shared memory per block, whether each warp owns one unit."""
    plan = (ctypes.c_int * 7)()
    check(kernels.lib("lstm_scan").rvt_lstm_scan_plan(
        int(x_f32), int(C > _FUSED_MAX_C), T, rows, C, plan),
        "lstm_scan_plan")
    return dict(zip(("cluster", "rows", "clusters", "resident", "warps",
                     "smem", "one_unit"), plan))


def fused_lstm_scan(x_seq: torch.Tensor, lstm_w: torch.Tensor,
                    lstm_b: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                    *, with_c_seq: bool = False, plain: bool = False,
                    lstm_wt: torch.Tensor | None = None,
                    x_bf16: torch.Tensor | None = None):
    """Scan the ConvLSTM cell over a [T, B, H, W, C] window (bf16 or f32
    input, rounded to bf16 as the cell reads it). lstm_w [2C, 4C] bf16,
    lstm_b [4C] bf16, h0/c0 [B, H, W, C] f32; ``lstm_wt`` is
    ``lstm_weights_t(lstm_w)`` when the caller keeps it; ``x_bf16``
    bf16(x_seq) when the caller has it. Returns (h_seq bf16, h_T f32, c_T
    f32); with ``with_c_seq`` (training) (h_seq, c_seq f32, h_T, c_T).

    On the card, C <= 64 runs one kernel with [x_t, h] . W in its time
    loop. Wider, x . W_x for every step is first one product over all
    T*B*H*W rows (``gemm_bf16`` "rt_f32", f32; in chunks of steps that
    keep its buffer within 512 MiB), and the recurrent kernel adds h . W_h
    to it in f32 before the bf16 rounding. Every launch, the product's
    too, counts on ``LSTM_SCAN`` (``lstm_scan_launches``)."""
    if plain or not x_seq.is_cuda:
        return lstm_scan_plain(x_seq, lstm_w, lstm_b, h0, c0, with_c_seq)
    T, B, H, W, C = x_seq.shape
    rows = B * H * W
    b = lstm_b.reshape(-1)
    h0, c0 = h0.float().contiguous(), c0.float().contiguous()
    wt = lstm_weights_t(lstm_w) if lstm_wt is None else lstm_wt
    check_operands("lstm_scan", x_seq, lstm_w, wt, b, h0, c0)
    need(x_seq.dtype in (torch.float32, torch.bfloat16)
         and lstm_w.dtype == wt.dtype == b.dtype == torch.bfloat16
         and tuple(lstm_w.shape) == (2 * C, 4 * C)
         and tuple(wt.shape) == (2, 4 * C, C) and b.numel() == 4 * C
         and tuple(h0.shape) == (B, H, W, C) == tuple(c0.shape)
         and C % 16 == 0 and C <= 512,
         "lstm_scan: x [T, B, H, W, C] f32/bf16, w [2C, 4C] bf16, "
         "wt [2, 4C, C] bf16, b [4C] bf16, h0/c0 [B, H, W, C] f32; "
         "C % 16 == 0 and C <= 512")
    dev = x_seq.device
    h_seq = torch.empty(x_seq.shape, dtype=torch.bfloat16, device=dev)
    c_seq = torch.empty(x_seq.shape, dtype=torch.float32,
                        device=dev) if with_c_seq else None
    hT = torch.empty_like(h0)
    cT = torch.empty_like(c0)
    lib = kernels.lib("lstm_scan")
    if C <= _FUSED_MAX_C:
        err = lib.rvt_lstm_scan(
            ptr(x_seq), int(x_seq.dtype == torch.float32), None, ptr(wt),
            ptr(b), ptr(h0), ptr(c0), ptr(h_seq),
            ptr(c_seq) if c_seq is not None else None, ptr(hT), ptr(cT),
            T, rows, C, stream_ptr(x_seq))
        check(err, "lstm_scan")
        LSTM_SCAN.launches += 1
    else:
        if x_bf16 is None:
            x_bf16 = x_seq.to(torch.bfloat16)
        check_operands("lstm_scan", x_bf16)
        need(x_bf16.dtype == torch.bfloat16 and x_bf16.shape == x_seq.shape,
             "lstm_scan: x_bf16 must be bf16 like x_seq")
        xb = x_bf16.view(T * rows, C)
        steps = _hoist_steps(T, rows, C)
        h_in, c_in = h0, c0
        for t0 in range(0, T, steps):
            t1 = min(T, t0 + steps)
            xw = gemm_bf16(xb[t0 * rows:t1 * rows], wt[0], "rt_f32",
                           counter=LSTM_SCAN)
            err = lib.rvt_lstm_scan(
                None, 0, ptr(xw), ptr(wt), ptr(b), ptr(h_in), ptr(c_in),
                ptr(h_seq[t0:t1]),
                ptr(c_seq[t0:t1]) if c_seq is not None else None, ptr(hT),
                ptr(cT), t1 - t0, rows, C, stream_ptr(x_seq))
            check(err, "lstm_scan")
            LSTM_SCAN.launches += 1
            h_in, c_in = hT, cT
    if with_c_seq:
        return h_seq, c_seq, hT, cT
    return h_seq, hT, cT


def lstm_scan_bwd_plain(x_seq, w, b, h0, c0, h_seq, c_seq, dh_seq, dhT, dcT):
    """BPTT of the cell over the window, step by step in reverse
    (``_lstm_scan_bwd_kernel``): the gates recomputed from bf16(x_t), the
    carry inputs h_{t-1} (bf16) and c_{t-1}; dmix rounded to bf16 for the
    products, db from the f32 dmix. Returns (dx f32, dW f32 [2C, 4C],
    db f32 [4C], dh0, dc0)."""
    T = x_seq.shape[0]
    C = h0.shape[-1]
    wf = w.float()
    dh, dc = dhT.float(), dcT.float()
    dx = torch.empty(x_seq.shape, dtype=torch.float32, device=x_seq.device)
    dW = torch.zeros((2 * C, 4 * C), dtype=torch.float32,
                     device=x_seq.device)
    db = torch.zeros(4 * C, dtype=torch.float32, device=x_seq.device)
    for t in reversed(range(T)):
        h_prev = h0.to(torch.bfloat16) if t == 0 else h_seq[t - 1]
        c_prev = c0.float() if t == 0 else c_seq[t - 1]
        xh = torch.cat([x_seq[t].to(torch.bfloat16), h_prev], dim=-1).float()
        f, i, o, g, c_t, _ = _lstm_cell(xh, w, b, c_prev)
        dmix, dc = _lstm_cell_bwd(f, i, o, g, c_prev, c_t,
                                  dh + dh_seq[t].float(), dc)
        dmix_bf = dmix.to(torch.bfloat16).float()
        dW += xh.reshape(-1, 2 * C).t() @ dmix_bf.reshape(-1, 4 * C)
        db += dmix.reshape(-1, 4 * C).sum(0)
        dxh = dmix_bf @ wf.t()
        dx[t] = dxh[..., :C]
        dh = dxh[..., C:]
    return dx, dW, db, dh, dc


def _bwd_steps(T: int, rows: int, C: int) -> int:
    """Steps of gates that one launch of K8's mix product forms: the bf16
    [steps * rows, 4C] buffer stays within ``_HOIST_BYTES``."""
    return max(1, min(T, _HOIST_BYTES // (rows * 4 * C * 2)))


def lstm_scan_bwd_launches(T: int, rows: int, C: int) -> int:
    """Kernel launches of one K8 call (``lstm_scan_bwd_launch``) over T
    steps of ``rows`` pixels, all counted on ``LSTM_SCAN_BWD``: the pack of
    xh, per chunk of steps the gates' product (K2 "bias") and the reverse
    scan, then dx as one K2 "rt_f32" product; at T = 1 the pack, the
    gates, the cell and one K2 product for dx and dh_0 together."""
    return 2 + 2 * _bwd_chunks(T, rows, C)


def _bwd_chunks(T: int, rows: int, C: int) -> int:
    return -(-T // _bwd_steps(T, rows, C))


def lstm_scan_bwd_part_rows(T: int, rows: int, C: int) -> int:
    """Rows of K8's f32 db partials: one per 32 rows, per chunk of steps
    (rows past a launch's clusters are zeros)."""
    return _bwd_chunks(T, rows, C) * -(-rows // _PT)


def lstm_scan_bwd_plan(T: int, rows: int, C: int) -> Dict:
    """The scan (T > 1) or cell (T = 1) launch's plan on this card (for
    reports): cluster size, rows per cluster, clusters, clusters resident
    at once, threads per block, shared memory per block, and the chunks of
    steps."""
    plan = (ctypes.c_int * 6)()
    check(kernels.lib("lstm_scan_bwd").rvt_lstm_bwd_scan_plan(
        rows, C, int(T > 1), plan), "lstm_scan_bwd_plan")
    out = dict(zip(("cluster", "rows", "clusters", "resident", "threads",
                    "smem"), plan))
    out["chunks"] = _bwd_chunks(T, rows, C)
    return out


def lstm_scan_bwd(x_seq, w, b, h0, c0, h_seq, c_seq, dh_seq, dhT, dcT, *,
                  plain: bool = False):
    """Backward of ``fused_lstm_scan(..., with_c_seq=True)``: x_seq
    [T, B, H, W, C] f32 (the cell input, rounded to bf16 as in the
    forward), w [2C, 4C] / b [4C] bf16, h0/c0 f32, the forward's h_seq
    (bf16) and c_seq (f32), the cotangents dh_seq (bf16), dhT and dcT
    (f32). K8 (``lstm_scan_bwd_launch``) writes [x, h_prev], bf16(dmix),
    dx and the carries; K6 forms dW from the first two; db is the in-order
    sum of K8's partials. Returns (dx f32, dW f32, db f32, dh0, dc0)."""
    if plain or not x_seq.is_cuda:
        return lstm_scan_bwd_plain(x_seq, w, b, h0, c0, h_seq, c_seq,
                                   dh_seq, dhT, dcT)
    T, B, H, W, C = x_seq.shape
    bb = b.reshape(-1)
    check_operands("lstm_scan_bwd", x_seq, w, bb, h0, c0, h_seq, c_seq,
                   dh_seq, dhT, dcT)
    need(x_seq.dtype in (torch.float32, torch.bfloat16)
         and w.dtype == bb.dtype == h_seq.dtype == dh_seq.dtype
         == torch.bfloat16
         and h0.dtype == c0.dtype == c_seq.dtype == dhT.dtype == dcT.dtype
         == torch.float32
         and tuple(w.shape) == (2 * C, 4 * C) and bb.numel() == 4 * C
         and h_seq.shape == c_seq.shape == dh_seq.shape == x_seq.shape
         and tuple(h0.shape) == tuple(c0.shape) == tuple(dhT.shape)
         == tuple(dcT.shape) == (B, H, W, C)
         and C % 16 == 0 and C <= 512,
         "lstm_scan_bwd: x [T, B, H, W, C] f32/bf16, w [2C, 4C] / b [4C] "
         "bf16, h_seq / dh_seq bf16, c_seq f32 like x, h0 / c0 / dhT / dcT "
         "f32 [B, H, W, C]; C % 16 == 0 and C <= 512")
    dx, dmix, xh, part, dh0, dc0 = lstm_scan_bwd_launch(
        x_seq, w, bb, h0, c0, h_seq, c_seq, dh_seq, dhT, dcT)
    return dx, gemm_bf16_wgrad(xh, dmix), sum_parts(part), dh0, dc0


def lstm_scan_bwd_launch(x_seq, w, bb, h0, c0, h_seq, c_seq, dh_seq, dhT,
                         dcT):
    """K8 alone (operands checked by ``lstm_scan_bwd``), every launch
    counted on ``LSTM_SCAN_BWD`` (``lstm_scan_bwd_launches``): the pack
    writes xh = [bf16(x_t), h_{t-1}]; K2's "bias" epilogue forms the gates
    mix = bf16(bf16(xh . W) + b) for a chunk of steps at once; the scan
    runs that chunk's steps in reverse with the (dh, dc) carry on chip and
    only bf16(dmix) . W_h^T in its loop, the carry chained from chunk to
    chunk; then dx = bf16(dmix) . W_x^T is one K2 "rt_f32" product over
    every step. At T = 1 there is no recurrence: the cell kernel writes
    dmix and dc_0, and one K2 product over W gives dx and dh_0 together
    (column views of its [rows, 2C] output). Returns (dx, bf16(dmix)
    [T*B*P, 4C], xh [T*B*P, 2C], db partials, dh0, dc0)."""
    T, B, H, W, C = x_seq.shape
    rows = B * H * W
    dev = x_seq.device
    lib = kernels.lib("lstm_scan_bwd")
    stream = stream_ptr(x_seq)
    xh = torch.empty((T * rows, 2 * C), dtype=torch.bfloat16, device=dev)
    check(lib.rvt_lstm_bwd_pack(
        ptr(x_seq), int(x_seq.dtype == torch.float32), ptr(h_seq), ptr(h0),
        ptr(xh), T, rows, C, stream), "lstm_scan_bwd pack")
    LSTM_SCAN_BWD.launches += 1
    dmix = torch.empty((T * rows, 4 * C), dtype=torch.bfloat16, device=dev)
    n_part = -(-rows // _PT)
    steps = _bwd_steps(T, rows, C)
    part = torch.empty((lstm_scan_bwd_part_rows(T, rows, C), 4 * C),
                       dtype=torch.float32, device=dev)
    dh, dc = dhT, dcT
    for k, t1 in enumerate(range(T, 0, -steps)):
        t0 = max(0, t1 - steps)
        mix = gemm_bf16(xh[t0 * rows:t1 * rows], w, "bias", bias=bb,
                        counter=LSTM_SCAN_BWD)
        dh_out = torch.empty_like(h0) if T > 1 else None
        dc_out = torch.empty_like(c0)
        check(lib.rvt_lstm_bwd_scan(
            ptr(mix), ptr(w), ptr(c_seq), ptr(c0), ptr(dh_seq), ptr(dh),
            ptr(dc), ptr(dmix), ptr(part[k * n_part:(k + 1) * n_part]),
            ptr(dh_out) if dh_out is not None else None, ptr(dc_out), t0,
            t1, rows, C, int(T > 1), stream), "lstm_scan_bwd scan")
        LSTM_SCAN_BWD.launches += 1
        dh, dc = dh_out, dc_out
    if T == 1:
        dxh = gemm_bf16(dmix, w, "rt_f32", counter=LSTM_SCAN_BWD)
        return (dxh[:, :C].view(x_seq.shape), dmix, xh, part,
                dxh[:, C:].view(h0.shape), dc)
    dx = gemm_bf16(dmix, w[:C], "rt_f32", counter=LSTM_SCAN_BWD)
    return dx.view(x_seq.shape), dmix, xh, part, dh, dc


def fused_conv_lstm(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                    w: torch.Tensor, b: torch.Tensor, *, plain: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ConvLSTM step (``rvt_tpu/ops/fused_lstm.py:fused_conv_lstm``):
    ``fused_lstm_scan`` at T = 1 (w [2C, 4C] and b bf16). Returns (h_t,
    c_t) f32."""
    _, hT, cT = fused_lstm_scan(x.unsqueeze(0).contiguous(), w.contiguous(),
                                b, h.contiguous(), c.contiguous(),
                                plain=plain)
    return hT, cT


def fused_stage_scan(x_seq: torch.Tensor,
                     params_window: Dict[str, torch.Tensor],
                     params_grid: Dict[str, torch.Tensor],
                     lstm_w: torch.Tensor, lstm_b: torch.Tensor,
                     h0: torch.Tensor, c0: torch.Tensor, *, heads: int,
                     dim_head: int, part: Tuple[int, int], eps: float,
                     ds_ln_params: Sequence[torch.Tensor] = (),
                     ds_eps: float = 1e-5, plain: bool = False,
                     lstm_wt: torch.Tensor | None = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One backbone stage over a whole [T, B, H, W, C] window: the attention
    pair over all T*B frames (K1-K3), then the LSTM scan (K4) on its f32
    residual output. With ``ds_ln_params`` = (scale, bias) x_seq is the raw
    downsample-conv output and its LayerNorm runs first; otherwise x_seq
    must be bf16 and already normed. ``lstm_wt`` as in
    ``fused_lstm_scan``. Returns (h_seq [T, B, H, W, C] bf16, h_T f32,
    c_T f32), as the TPU kernel does."""
    T, B, H, W, C = x_seq.shape
    # the kernels' wide K4 reads bf16(R), which the pair's last product
    # writes beside R
    hoist = not plain and x_seq.is_cuda and C > _FUSED_MAX_C
    R = fused_attention_pair(
        x_seq.reshape(T * B, H, W, C), params_window, params_grid,
        heads=heads, dim_head=dim_head, part=part, skip_first_norm=True,
        eps=eps, ds_ln_params=ds_ln_params, ds_eps=ds_eps, plain=plain,
        with_bf16=hoist)
    R, Rb = R if hoist else (R, None)
    shape = (T, B, H, W, C)
    return fused_lstm_scan(R.view(shape), lstm_w, lstm_b, h0, c0,
                           plain=plain, lstm_wt=lstm_wt,
                           x_bf16=Rb.view(shape) if hoist else None)


def fused_stage(x: torch.Tensor, params_window: Dict[str, torch.Tensor],
                params_grid: Dict[str, torch.Tensor], lstm_w: torch.Tensor,
                lstm_b: torch.Tensor, h: torch.Tensor, c: torch.Tensor, *,
                heads: int, dim_head: int, part: Tuple[int, int], eps: float,
                ds_ln_params: Sequence[torch.Tensor] = (),
                ds_eps: float = 1e-5, plain: bool = False,
                lstm_wt: torch.Tensor | None = None
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
        ds_ln_params=ds_ln_params, ds_eps=ds_eps, plain=plain,
        lstm_wt=lstm_wt)
    return h_t, c_t


# The JAX package's 'split' serving mode (pair over T*B frames, then the
# LSTM scan) is the only composition on Hopper.
split_stage_scan = fused_stage_scan
