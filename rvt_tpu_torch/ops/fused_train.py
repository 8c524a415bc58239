"""Backbone-stage training on hand-written Hopper kernels.

Port of ``rvt_tpu/ops/fused_train.py`` in its 'split' composition
(``split_stage_scan_train``): the JAX package's docstring states that its
forward equals the one-kernel ``fused_stage_scan_train`` bit for bit, and
on Hopper it is the only composition, for the reason the serving port
splits the stage (``ops/fused_scan.py``): blocks run in no order, and only
the ConvLSTM recurs in time.

  ``FusedPairTrain``      downsample LN + window block + grid block over
                          all T*B frames (row 9, ``fused_pair_train``).
                          Forward K1-K3 with the unfolded-LayerScale
                          residual of K2; it saves exactly what the JAX
                          rule saves (x, ds_s, ds_b, win, grid, R1). The
                          backward recomputes each block from its input
                          (R1, or x) and runs K2's data-gradient
                          epilogues, K5 (LN backward), K6 (weight
                          gradients), K7 (attention backward) and the
                          column sums of ``train_reduce``.
  ``FusedLstmScanTrain``  the ConvLSTM over the window (row 10,
                          ``fused_lstm_scan_train``): K4 with c_seq, then
                          K8's reverse scan with the (dh, dc) carry and K6
                          for dW.
  ``split_stage_scan_train`` = ``fused_stage_scan_train``: the two (row 8).
  ``fused_stage_step_train``  one time step of a stage (row 7): the two at
                          T = 1, on the B frames of the step.

Numerics follow the JAX kernels (bf16 products with f32 sums, f32 LN
statistics, softmax and cell state; bf16 probabilities, dS, dmix; the
rounding points of ``_block_fwd`` / ``_block_bwd``). Every gradient leaves
its Function cast to its input's dtype, as the JAX VJPs cast to the
primal's dtype (weights, biases and LN affines bf16; gammas, h0, c0 f32).

The plain math of the JAX module (``_ln_fwd``, ``_ln_bwd``, ``_gelu_fwd``,
``_gelu_bwd``, ``_attn_heads_fwd``, ``_attn_heads_bwd``,
``_lstm_recompute``, ``_lstm_bwd_chunked``) lives beside the kernels whose
plain versions use it and is re-exported here under the JAX names.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from rvt_tpu_torch.ops.fused_attention import (_attn_heads_bwd,
                                               _attn_heads_fwd, _gelu_grad,
                                               _gelu_tanh, _ln_bwd, _ln_fwd,
                                               col_sum, dense_attention_ok,
                                               gemm_bf16, gemm_bf16_wgrad,
                                               layer_scale_bwd, ln_rows,
                                               ln_rows_bwd,
                                               partition_attention,
                                               partition_attention_bwd,
                                               partition_geometry_ok)
from rvt_tpu_torch.ops.fused_scan import (_lstm_cell, _lstm_cell_bwd,
                                          fused_lstm_scan, lstm_scan_bwd)
from rvt_tpu_torch.ops.kernels import Counter

# The JAX package's 'split' train mode (rvt_tpu/ops/fused_train.py:1278):
# images of more than _SPLIT_MIN elements train over the whole window only.
_SPLIT_MIN = 512 * 1024
_SPLIT_MAX = 1024 * 1024

# Calls of row 7 that ran on the kernels (its composed kernels count their
# own launches as well).
STAGE_STEP_TRAIN = Counter("fused_stage_step_train")

# params per sub-block (train layout, LayerScale NOT folded):
# [ln1_s, ln1_b] (absent when skip_first_norm), qkv_w, qkv_b, proj_w,
# proj_b, ls1_g, ln2_s, ln2_b, fc1_w, fc1_b, fc2_w, fc2_b, ls2_g.
_N_TRAIN = 14
_N_TRAIN_SFN = 12

# The JAX module's names for the plain math (f32 in, f32 out; each caller
# rounds where the JAX kernel does).
_gelu_fwd, _gelu_bwd = _gelu_tanh, _gelu_grad
_lstm_recompute, _lstm_bwd_chunked = _lstm_cell, _lstm_cell_bwd


class StageCfg(NamedTuple):
    """The JAX cfg tuple (heads, dim_head, part, eps, ds_eps[, ds_ln]) and
    whether to run the kernels' plain versions. ``ds_ln=False``: the input
    arrives already layer-normed in bf16 (the token-mask path runs stage
    1's downsample LN and the mask-token replacement in torch), so the
    pair skips its downsample LN and the LN affine gets no cotangent from
    the Function (``_parse_cfg``)."""
    heads: int
    dim_head: int
    part: Tuple[int, int]
    eps: float
    ds_eps: float
    plain: bool = False
    ds_ln: bool = True


def train_block_params(block, skip_first_norm: bool) -> Tuple[torch.Tensor,
                                                              ...]:
    """One PartitionAttention module's parameters for the train kernels,
    made inside autograd on every step (``fused_train.train_block_params``):
    weights [in, out] and LN affines / biases in bf16, the LayerScale
    gammas unfolded, f32."""
    bf = torch.bfloat16
    attn, mlp = block.self_attn, block.mlp
    fc1, fc2 = mlp.net[0][0], mlp.net[2]

    def w(lin):
        return lin.weight.to(bf).t().contiguous()

    out: List[torch.Tensor] = []
    if not skip_first_norm:
        out += [block.norm1.weight.to(bf), block.norm1.bias.to(bf)]
    out += [w(attn.qkv), attn.qkv.bias.to(bf), w(attn.proj),
            attn.proj.bias.to(bf), block.ls1.gamma,
            block.norm2.weight.to(bf), block.norm2.bias.to(bf),
            w(fc1), fc1.bias.to(bf), w(fc2), fc2.bias.to(bf),
            block.ls2.gamma]
    return tuple(out)


def _block_fwd(R: torch.Tensor, prm: Sequence[torch.Tensor],
               x_in_bf16: torch.Tensor | None, cfg: StageCfg, *,
               window: bool, out: torch.Tensor | None = None,
               store: bool = False):
    """One sub-block forward on the f32 residual R [N, H, W, C]
    (``_block_fwd``): R_mid = R + ls1 * proj(attn(LN1(R) or x_in)), R_out =
    R_mid + ls2 * fc2(gelu(fc1(LN2(R_mid)))). R_mid and R_out go to ``out``
    (may be R; new when None). Returns R_out [N, H, W, C], or with
    ``store`` the tensors the backward reads (R_out is then not formed)."""
    N, H, W, C = R.shape
    M = N * H * W
    p = cfg.plain
    i = 0
    if x_in_bf16 is None:
        xa = ln_rows(R.view(M, C), prm[0], prm[1], cfg.eps, plain=p)
        i = 2
    else:
        xa = x_in_bf16.view(M, C)
    (qkv_w, qkv_b, proj_w, proj_b, ls1_g, ln2_s, ln2_b,
     fc1_w, fc1_b, fc2_w, fc2_b, ls2_g) = prm[i:i + 12]
    qkv = gemm_bf16(xa, qkv_w, "bias", bias=qkv_b, plain=p)
    attn = partition_attention(qkv.view(N, H, W, 3 * C), heads=cfg.heads,
                               dim_head=cfg.dim_head, part=cfg.part,
                               window=window, plain=p).view(M, C)
    kw = dict(want_aux=store, plain=p)
    R_mid = gemm_bf16(attn, proj_w, "residual_ls", bias=proj_b, gamma=ls1_g,
                      res_in=R.view(M, C),
                      out=None if out is None else out.view(M, C), **kw)
    if store:
        R_mid, unpart = R_mid
    y = ln_rows(R_mid, ln2_s, ln2_b, cfg.eps, plain=p)
    g = gemm_bf16(y, fc1_w, "gelu", bias=fc1_b, **kw)
    if store:
        g, h1 = g
        m = gemm_bf16(g, fc2_w, "bias", bias=fc2_b, plain=p)
        return dict(xa=xa, qkv=qkv, attn=attn, unpart=unpart, R_mid=R_mid,
                    y=y, h1=h1, g=g, m=m, shape=(N, H, W, C))
    gemm_bf16(g, fc2_w, "residual_ls", bias=fc2_b, gamma=ls2_g,
              res_in=R_mid, out=R_mid, plain=p)
    return R_mid.view(N, H, W, C)


def _block_bwd(dR_out: torch.Tensor, sv: Dict, prm: Sequence[torch.Tensor],
               R_in: torch.Tensor | None, cfg: StageCfg, *, window: bool):
    """One sub-block backward (``_block_bwd``) from the cotangent dR_out
    [M, C] f32, which it updates in place into dR_mid and returns as the
    input's cotangent. ``R_in`` is the block's f32 input for the LN1
    backward, None for the window block (skip_first_norm): its x feeds
    both the residual and the attention, so dxa is added into dR_mid
    (``_bwd_window_kernel`` :713-717). Returns (dR_in [M, C] f32, grads
    in ``prm`` order, f32)."""
    p = cfg.plain
    i = 0 if R_in is None else 2
    (qkv_w, qkv_b, proj_w, proj_b, ls1_g, ln2_s, ln2_b,
     fc1_w, fc1_b, fc2_w, fc2_b, ls2_g) = prm[i:i + 12]
    N, H, W, C = sv["shape"]
    M = N * H * W
    # MLP half: R_out = R_mid + f32(m) * ls2
    dm, dfc2_b, dls2_g = layer_scale_bwd(dR_out, sv["m"], ls2_g, plain=p)
    dfc2_w = gemm_bf16_wgrad(sv["g"], dm, plain=p)
    dh1, dfc1_b = gemm_bf16(dm, fc2_w, "rt_gelu_bwd", aux=sv["h1"],
                            plain=p)
    dfc1_w = gemm_bf16_wgrad(sv["y"], dh1, plain=p)
    dy = gemm_bf16(dh1, fc1_w, "rt_f32", plain=p)
    dR_mid, dln2_s, dln2_b = ln_rows_bwd(sv["R_mid"], dy, ln2_s, cfg.eps,
                                         dres=dR_out, plain=p)
    # attention half: R_mid = R_in + f32(unpart) * ls1
    dproj, dproj_b, dls1_g = layer_scale_bwd(dR_mid, sv["unpart"], ls1_g,
                                             plain=p)
    dproj_w = gemm_bf16_wgrad(sv["attn"], dproj, plain=p)
    do = gemm_bf16(dproj, proj_w, "rt_bf16", plain=p)
    dqkv = partition_attention_bwd(
        sv["qkv"].view(N, H, W, 3 * C), do.view(N, H, W, C),
        heads=cfg.heads, dim_head=cfg.dim_head, part=cfg.part,
        window=window, plain=p).view(M, 3 * C)
    dqkv_w = gemm_bf16_wgrad(sv["xa"], dqkv, plain=p)
    dqkv_b = col_sum(dqkv, plain=p)
    grads = [dqkv_w, dqkv_b, dproj_w, dproj_b, dls1_g, dln2_s, dln2_b,
             dfc1_w, dfc1_b, dfc2_w, dfc2_b, dls2_g]
    if R_in is None:
        gemm_bf16(dqkv, qkv_w, "rt_acc", out=dR_mid, plain=p)
        return dR_mid, grads
    dxa = gemm_bf16(dqkv, qkv_w, "rt_f32", plain=p)
    dR_in, dln1_s, dln1_b = ln_rows_bwd(R_in.view(M, C), dxa, prm[0],
                                        cfg.eps, dres=dR_mid, plain=p)
    return dR_in, [dln1_s, dln1_b] + grads


def _ds_ln(cfg: StageCfg, x, ds_s, ds_b):
    """The window block's input as (bf16 rows, the f32 residual R0 [N, H,
    W, C], a new buffer): the downsample LN of x, or with ``ds_ln=False``
    x itself (``_recompute_R1``)."""
    N, H, W, C = x.shape
    rows = x.reshape(N * H * W, C)
    if not cfg.ds_ln:
        return rows, rows.float().view(N, H, W, C)
    x_bf16, R = ln_rows(rows, ds_s, ds_b, cfg.ds_eps, with_f32=True,
                        plain=cfg.plain)
    return x_bf16, R.view(N, H, W, C)


def _pair_fwd(cfg: StageCfg, x, ds_s, ds_b, win, grid):
    """Downsample LN + window block -> R1 (kept, as ``_pair_fwd_win_
    kernel`` stores it), then the grid block on a new buffer -> R2."""
    x_bf16, R = _ds_ln(cfg, x, ds_s, ds_b)
    R1 = _block_fwd(R, win, x_bf16, cfg, window=True, out=R)
    R2 = _block_fwd(R1, grid, None, cfg, window=False)
    return R1, R2


def _cast(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A gradient as its parameter's shape and dtype (trap: the JAX VJP
    casts every cotangent to the primal's dtype before it leaves)."""
    return g.reshape(p.shape).to(p.dtype)


class FusedPairTrain(torch.autograd.Function):
    """``fused_pair_train``: (cfg, x [N, H, W, C] bf16 raw downsample-conv
    output, ds_s, ds_b, *win(12), *grid(14)) -> R2 [N, H, W, C] f32."""

    @staticmethod
    def forward(ctx, cfg: StageCfg, x, ds_s, ds_b, *params):
        x = x.contiguous()
        win, grid = params[:_N_TRAIN_SFN], params[_N_TRAIN_SFN:]
        R1, R2 = _pair_fwd(cfg, x, ds_s, ds_b, win, grid)
        ctx.cfg = cfg
        ctx.save_for_backward(x, ds_s, ds_b, *params, R1)
        return R2

    @staticmethod
    def backward(ctx, dR2):
        cfg = ctx.cfg
        x, ds_s, ds_b, *rest = ctx.saved_tensors
        params, R1 = rest[:-1], rest[-1]
        win, grid = params[:_N_TRAIN_SFN], params[_N_TRAIN_SFN:]
        N, H, W, C = x.shape
        M = N * H * W
        # grid block from the R1 checkpoint; dR2 is autograd's: copied
        sv = _block_fwd(R1, grid, None, cfg, window=False, store=True)
        dR1, dgrid = _block_bwd(
            dR2.reshape(M, C).to(torch.float32, copy=True), sv, grid, R1,
            cfg, window=False)
        del sv
        # window block, recomputed from x through the downsample LN
        x_bf16, R0 = _ds_ln(cfg, x, ds_s, ds_b)
        sv = _block_fwd(R0, win, x_bf16, cfg, window=True, out=R0,
                        store=True)
        dxbf, dwin = _block_bwd(dR1, sv, win, None, cfg, window=True)
        del sv
        if cfg.ds_ln:
            dx, dds_s, dds_b = ln_rows_bwd(x.view(M, C), dxbf, ds_s,
                                           cfg.ds_eps, plain=cfg.plain)
            dds_s, dds_b = _cast(dds_s, ds_s), _cast(dds_b, ds_b)
        else:  # no LN here: None is autograd's zero cotangent
            dx, dds_s, dds_b = dxbf, None, None
        return (None, dx.view(x.shape).to(x.dtype), dds_s, dds_b,
                *[_cast(g, p) for g, p in zip(dwin, win)],
                *[_cast(g, p) for g, p in zip(dgrid, grid)])


class FusedLstmScanTrain(torch.autograd.Function):
    """``fused_lstm_scan_train``: (plain, x_seq [T, B, H, W, C] f32 (R2),
    lstm_w [2C, 4C] bf16, lstm_b [4C] bf16, h0, c0 f32[, lstm_wt: K4's
    layout of lstm_w, kept by the per-step caller]) -> (h_seq bf16, h_T
    f32, c_T f32). Saves what ``_lstm_scan_train_fwd`` saves."""

    @staticmethod
    def forward(ctx, plain: bool, x_seq, w, b, h0, c0, wt=None):
        h0 = h0.float().contiguous()
        c0 = c0.float().contiguous()
        h_seq, c_seq, hT, cT = fused_lstm_scan(
            x_seq.contiguous(), w, b, h0, c0, with_c_seq=True, plain=plain,
            lstm_wt=wt)
        ctx.plain = plain
        ctx.save_for_backward(x_seq, w, b, h0, c0, h_seq, c_seq)
        return h_seq, hT, cT

    @staticmethod
    def backward(ctx, dh_seq, dhT, dcT):
        x_seq, w, b, h0, c0, h_seq, c_seq = ctx.saved_tensors
        # the cotangent into the cell's backward is rounded to bf16
        # (``_lstm_scan_train_bwd`` :1607); dhT and dcT stay f32
        dx, dW, db, dh0, dc0 = lstm_scan_bwd(
            x_seq.contiguous(), w, b, h0, c0, h_seq, c_seq,
            dh_seq.to(torch.bfloat16).contiguous(),
            dhT.float().contiguous(), dcT.float().contiguous(),
            plain=ctx.plain)
        return (None, dx.to(x_seq.dtype), _cast(dW, w), _cast(db, b), dh0,
                dc0, None)


def split_stage_scan_train(cfg: StageCfg, x_seq, ds_s, ds_b, win, grid,
                           lstm_w, lstm_b, h0, c0):
    """One backbone stage over a [T, B, H, W, C] window, differentiable:
    the attention pair over all T*B frames, then the LSTM scan. x_seq is
    the bf16 raw downsample-conv output; win / grid from
    ``train_block_params``. Returns (h_seq bf16, h_T f32, c_T f32)."""
    T, B, H, W, C = x_seq.shape
    y = FusedPairTrain.apply(cfg, x_seq.reshape(T * B, H, W, C), ds_s, ds_b,
                             *win, *grid)
    return FusedLstmScanTrain.apply(cfg.plain, y.view(T, B, H, W, C), lstm_w,
                                    lstm_b, h0, c0)


# On Hopper the whole-stage train scan is this composition.
fused_stage_scan_train = split_stage_scan_train


def fused_stage_step_train(cfg: StageCfg, x, ds_s, ds_b, win, grid, lstm_w,
                           lstm_b, h, c, lstm_wt=None):
    """One backbone stage for one time step, differentiable in every input
    (``rvt_tpu/ops/fused_train.py:fused_stage_step_train``): x [B, H, W, C]
    bf16 (the raw downsample-conv output, or normed with ``ds_ln=False``),
    h and c f32. Returns (h_t, c_t) f32.

    On TPU it is one forward and three backward kernels, split only for
    Mosaic's VMEM stack; here it is ``FusedPairTrain`` over the B frames
    and ``FusedLstmScanTrain`` at T = 1, the same kernels as the
    whole-window stage (K1-K3 and K4 forward; K8, K7, K6, K5, K2's data
    gradients and ``train_reduce`` backward), so the forward equals
    ``split_stage_scan_train``'s step for step. The caller feeds h_t back
    as the next step's h and uses ``h_t.to(bf16)`` as the feature:
    autograd then sums the two cotangents in f32, unrounded, and hands K8
    that sum as dhT with a zero dh_seq, which K8 adds to it exactly (JAX
    reads dh_t as f32, ``_bwd_lstm_kernel``). The weight gradients leave
    each call in the weights' dtype, so over a window autograd sums them
    in bf16, step T-1 first, as JAX's scan transpose does. ``lstm_wt``:
    K4's layout of lstm_w (``lstm_weights_t``), which a caller that steps
    one stage over a window makes once."""
    if not cfg.plain and x.is_cuda:
        STAGE_STEP_TRAIN.launches += 1
    B, H, W, C = x.shape
    y = FusedPairTrain.apply(cfg, x, ds_s, ds_b, *win, *grid)
    _, h_t, c_t = FusedLstmScanTrain.apply(cfg.plain, y.view(1, B, H, W, C),
                                           lstm_w, lstm_b, h, c, lstm_wt)
    return h_t, c_t


def train_stage_ok(H: int, W: int, C: int, part: Tuple[int, int], *,
                   scan: bool) -> bool:
    """Whether ``rvt_tpu/ops/fused_train.py:train_stage_mode(scan=scan)``
    is not None: the JAX package trains an H x W x C stage on its kernels
    over the whole window (``scan``) or per step. Where it does not, it
    runs the XLA module path (erf-gelu, LayerScale not folded), and so
    does the port (``models/detector.py:stage_routes``). Only that outcome
    is copied, not the TPU sizing behind it."""
    per_image = H * W * C
    grad_bytes = 4 * (2 * (3 * C * C + C * C + 8 * C * C) + 8 * C * C)
    if grad_bytes + 30 * per_image <= 56 * 2 ** 20 and per_image <= _SPLIT_MIN:
        return (partition_geometry_ok(H, W, C, part)
                or dense_attention_ok(H, W))
    return (scan and per_image <= _SPLIT_MAX
            and partition_geometry_ok(H, W, C, part))
