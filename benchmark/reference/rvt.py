"""The plain reference of RVT: recurrent MaxViT backbone, PAFPN and YOLOX
head, as functions of one upstream-named state dict.

Written from the published model (RVT, Gehrig & Scaramuzza, CVPR 2023;
upstream ``models/detection/recurrent_backbone/maxvit_rnn.py``,
``models/layers/maxvit/maxvit.py``, ``models/layers/rnn.py``,
``models/detection/yolox/models/{yolo_pafpn,yolo_head,network_blocks}.py``)
for the variant the benchmark's configurations state: one attention pair
a stage (window then grid attention, LayerScale, a GELU MLP), an
overlapping strided-conv downsample with an affine LayerNorm, a 1x1
ConvLSTM cell, a PAFPN of CSP layers and a decoupled YOLOX head with
SiLU, BatchNorm and no depthwise convs. Everything runs in float32
(``precision.F32``; the caller turns TF32 off) or with the products'
operands rounded as ``precision.FP8`` rounds them (the control).

Departures from the upstream code, none of which changes the function:
the backbone runs a window stage by stage (each stage's downsample and
attention over all T*B frames at once, then the cell a step at a time),
which is what a step at a time computes; BatchNorm in training takes the
biased batch variance into its running buffer with momentum 0.9 (the
flax convention the configurations train with). The GELU is the exact
erf form of the published model.

Nothing here imports the program under test; the state dict's names and
shapes come from ``specs`` below, and the program loads the same dict.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.precision import F32, Precision

Params = Dict[str, torch.Tensor]
State = Tuple[torch.Tensor, torch.Tensor]  # (h, c), each [B, h, w, C]

PRIOR_LOGIT = -math.log((1 - 0.01) / 0.01)  # YOLOX's cls/obj bias init
BN_EPS, BN_MOMENTUM = 1e-5, 0.9


# --------------------------------------------------------------------------
# Architecture numbers and the state dict's layout
# --------------------------------------------------------------------------


def stage_dims(A: dict) -> List[int]:
    return [A["embed_dim"] * m for m in A["dim_multiplier"]]


def strides(A: dict) -> List[int]:
    out, s = [], 1
    for i in range(len(A["dim_multiplier"])):
        s *= A["stem_patch_size"] if i == 0 else 2
        out.append(s)
    return out


def stage_hw(A: dict) -> List[Tuple[int, int]]:
    H, W = A["in_res_hw"]
    return [(H // s, W // s) for s in strides(A)]


def fpn_channels(A: dict) -> Tuple[int, int, int]:
    dims = stage_dims(A)
    return tuple(dims[s - 1] for s in A["fpn_in_stages"])


def head_hidden(A: dict) -> int:
    return int(256 * fpn_channels(A)[-1] / 1024)


def csp_depth(A: dict) -> int:
    return round(3 * A["fpn_depth"])


def _base_conv(name, cin, cout, k, groups=1):
    return [(f"{name}.conv.weight", (cout, cin // groups, k, k), "kernel"),
            (f"{name}.bn.weight", (cout,), "one"),
            (f"{name}.bn.bias", (cout,), "zero"),
            (f"{name}.bn.running_mean", (cout,), "zero"),
            (f"{name}.bn.running_var", (cout,), "one"),
            (f"{name}.bn.num_batches_tracked", (), "count")]


def _csp(name, cin, cout, n):
    hidden = int(cout * 0.5)
    out = (_base_conv(f"{name}.conv1", cin, hidden, 1)
           + _base_conv(f"{name}.conv2", cin, hidden, 1)
           + _base_conv(f"{name}.conv3", 2 * hidden, cout, 1))
    for j in range(n):
        out += _base_conv(f"{name}.m.{j}.conv1", hidden, hidden, 1)
        out += _base_conv(f"{name}.m.{j}.conv2", hidden, hidden, 3)
    return out


def _block(name, C, A, first_norm):
    r = A["mlp_ratio"]
    out = []
    if first_norm:
        out += [(f"{name}.norm1.weight", (C,), "one"),
                (f"{name}.norm1.bias", (C,), "zero")]
    out += [(f"{name}.self_attn.qkv.weight", (3 * C, C), "kernel"),
            (f"{name}.self_attn.qkv.bias", (3 * C,), "zero"),
            (f"{name}.self_attn.proj.weight", (C, C), "kernel"),
            (f"{name}.self_attn.proj.bias", (C,), "zero"),
            (f"{name}.ls1.gamma", (C,), "gamma"),
            (f"{name}.norm2.weight", (C,), "one"),
            (f"{name}.norm2.bias", (C,), "zero"),
            (f"{name}.mlp.net.0.0.weight", (r * C, C), "kernel"),
            (f"{name}.mlp.net.0.0.bias", (r * C,), "zero"),
            (f"{name}.mlp.net.2.weight", (C, r * C), "kernel"),
            (f"{name}.mlp.net.2.bias", (C,), "zero"),
            (f"{name}.ls2.gamma", (C,), "gamma")]
    return out


def specs(A: dict) -> List[Tuple[str, tuple, str]]:
    """Every entry of the upstream state dict: (name, shape, how it is
    initialised): ``kernel`` (lecun-normal, truncated at two deviations),
    ``zero``, ``one``, ``gamma`` (LayerScale), ``prior`` (the head's
    class and objectness biases), ``count`` (BatchNorm's step count)."""
    out = []
    cin = A["input_channels"]
    for i, C in enumerate(stage_dims(A)):
        f = A["stem_patch_size"] if i == 0 else 2
        k = 2 * f - 1
        p = f"backbone.stages.{i}"
        out += [(f"{p}.downsample_cf2cl.conv.weight", (C, cin, k, k),
                 "kernel"),
                (f"{p}.downsample_cf2cl.norm.weight", (C,), "one"),
                (f"{p}.downsample_cf2cl.norm.bias", (C,), "zero")]
        out += _block(f"{p}.att_blocks.0.att_window", C, A, False)
        out += _block(f"{p}.att_blocks.0.att_grid", C, A, True)
        out += [(f"{p}.lstm.conv1x1.weight", (4 * C, 2 * C, 1, 1), "kernel"),
                (f"{p}.lstm.conv1x1.bias", (4 * C,), "zero")]
        cin = C
    c2, c1, c0 = fpn_channels(A)
    n = csp_depth(A)
    out += _base_conv("fpn.lateral_conv0", c0, c1, 1)
    out += _csp("fpn.C3_p4", 2 * c1, c1, n)
    out += _base_conv("fpn.reduce_conv1", c1, c2, 1)
    out += _csp("fpn.C3_p3", 2 * c2, c2, n)
    out += _base_conv("fpn.bu_conv2", c2, c2, 3)
    out += _csp("fpn.C3_n3", 2 * c2, c1, n)
    out += _base_conv("fpn.bu_conv1", c1, c1, 3)
    out += _csp("fpn.C3_n4", 2 * c1, c0, n)
    hid, ncls = head_hidden(A), A["num_classes"]
    for k, c in enumerate((c2, c1, c0)):
        out += _base_conv(f"yolox_head.stems.{k}", c, hid, 1)
    for branch in ("cls_convs", "reg_convs"):
        for k in range(3):
            for j in range(2):
                out += _base_conv(f"yolox_head.{branch}.{k}.{j}", hid, hid, 3)
    for pred, n_out, bias in (("cls_preds", ncls, "prior"),
                              ("reg_preds", 4, "zero"),
                              ("obj_preds", 1, "prior")):
        for k in range(3):
            out += [(f"yolox_head.{pred}.{k}.weight", (n_out, hid, 1, 1),
                     "kernel"),
                    (f"yolox_head.{pred}.{k}.bias", (n_out,), bias)]
    return out


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------


def linear(x, w, b, prec: Precision):
    return F.linear(prec.q(x), prec.q(w), b)


def conv(x, w, b, stride, pad, prec: Precision, groups=1):
    """NCHW conv."""
    return F.conv2d(prec.q(x), prec.q(w), b, stride, pad, 1, groups)


def layer_norm(x, P, name, eps):
    C = x.shape[-1]
    return F.layer_norm(x, (C,), P[f"{name}.weight"], P[f"{name}.bias"], eps)


def _window_partition(x, ws):
    B, H, W, C = x.shape
    wh, ww = ws
    x = x.reshape(B, H // wh, wh, W // ww, ww, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, wh * ww, C)


def _window_reverse(win, ws, img):
    (H, W), (wh, ww) = img, ws
    x = win.reshape(-1, H // wh, W // ww, wh, ww, win.shape[-1])
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, H, W, win.shape[-1])


def _grid_partition(x, gs):
    B, H, W, C = x.shape
    gh, gw = gs
    x = x.reshape(B, gh, H // gh, gw, W // gw, C).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(-1, gh * gw, C)


def _grid_reverse(win, gs, img):
    (H, W), (gh, gw) = img, gs
    x = win.reshape(-1, H // gh, W // gw, gh, gw, win.shape[-1])
    return x.permute(0, 3, 1, 4, 2, 5).reshape(-1, H, W, win.shape[-1])


def self_attention(x, P, name, dh, prec):
    """x [N, L, C]; qkv laid out per head as (q | k | v) of dh each."""
    N, L, C = x.shape
    qkv = linear(x, P[f"{name}.qkv.weight"], P[f"{name}.qkv.bias"], prec)
    q, k, v = qkv.reshape(N, L, C // dh, 3 * dh).split(dh, dim=-1)
    s = torch.einsum("nlhd,nmhd->nhlm", prec.q(q), prec.q(k)) * dh ** -0.5
    a = torch.softmax(s, dim=-1)
    out = torch.einsum("nhlm,nmhd->nlhd", prec.q(a), prec.q(v))
    return linear(out.reshape(N, L, C), P[f"{name}.proj.weight"],
                  P[f"{name}.proj.bias"], prec)


def partition_block(x, P, name, A, window: bool, first_norm: bool, prec):
    """LN -> window or grid attention -> LayerScale -> residual; LN ->
    MLP -> LayerScale -> residual. x [N, H, W, C]."""
    part, eps = tuple(A["partition_size"]), A["norm_eps"]
    img = tuple(x.shape[1:3])
    y = layer_norm(x, P, f"{name}.norm1", eps) if first_norm else x
    attn = lambda t: self_attention(t, P, f"{name}.self_attn",  # noqa: E731
                                    A["dim_head"], prec)
    if window:
        y = _window_reverse(attn(_window_partition(y, part)), part, img)
    else:
        y = _grid_reverse(attn(_grid_partition(y, part)), part, img)
    x = x + y * P[f"{name}.ls1.gamma"]
    y = layer_norm(x, P, f"{name}.norm2", eps)
    y = F.gelu(linear(y, P[f"{name}.mlp.net.0.0.weight"],
                      P[f"{name}.mlp.net.0.0.bias"], prec))
    y = linear(y, P[f"{name}.mlp.net.2.weight"], P[f"{name}.mlp.net.2.bias"],
               prec)
    return x + y * P[f"{name}.ls2.gamma"]


def lstm_cell(x, h, c, w, b, prec):
    """The 1x1 ConvLSTM: gates (forget, input, output) and the cell
    update from [x, h]. x, h, c [B, h, w, C]; w [4C, 2C]."""
    C = x.shape[-1]
    mix = linear(torch.cat([x, h], dim=-1), w, b, prec)
    gates = torch.sigmoid(mix[..., :3 * C])
    cell = torch.tanh(mix[..., 3 * C:])
    c = gates[..., :C] * c + gates[..., C:2 * C] * cell
    return gates[..., 2 * C:] * torch.tanh(c), c


def backbone_window(P: Params, A: dict, ev: torch.Tensor,
                    states: Sequence[State], prec: Precision = F32):
    """The backbone over a window. ev [T, B, H, W, C_in] float, padded to
    ``in_res_hw``; states per stage. Returns (features of the FPN's
    stages, each [T, B, h, w, C]; final states)."""
    T, B = ev.shape[:2]
    x = ev.reshape((T * B,) + tuple(ev.shape[2:]))
    feats, out_states = {}, []
    for i, C in enumerate(stage_dims(A)):
        p = f"backbone.stages.{i}"
        f = A["stem_patch_size"] if i == 0 else 2
        k = 2 * f - 1
        x = conv(x.permute(0, 3, 1, 2), P[f"{p}.downsample_cf2cl.conv.weight"],
                 None, f, k // 2, prec).permute(0, 2, 3, 1)
        x = layer_norm(x, P, f"{p}.downsample_cf2cl.norm", A["norm_eps"])
        x = partition_block(x, P, f"{p}.att_blocks.0.att_window", A, True,
                            False, prec)
        x = partition_block(x, P, f"{p}.att_blocks.0.att_grid", A, False,
                            True, prec)
        x_seq = x.reshape((T, B) + tuple(x.shape[1:]))
        w = P[f"{p}.lstm.conv1x1.weight"][:, :, 0, 0]
        b = P[f"{p}.lstm.conv1x1.bias"]
        h, c = states[i]
        hs = []
        for t in range(T):
            h, c = lstm_cell(x_seq[t], h, c, w, b, prec)
            hs.append(h)
        out_states.append((h, c))
        h_seq = torch.stack(hs)
        feats[i + 1] = h_seq
        x = h_seq.reshape((T * B,) + tuple(h_seq.shape[2:]))
    return (tuple(feats[s] for s in A["fpn_in_stages"]), tuple(out_states))


# --------------------------------------------------------------------------
# PAFPN and head
# --------------------------------------------------------------------------


class BatchNorms:
    """BatchNorm's running buffers: read in evaluation, and in training
    replaced by 0.9 * running + 0.1 * batch (biased variance)."""

    def __init__(self, P: Params, train: bool):
        self.P, self.train = P, train
        self.updated: Params = {}

    def __call__(self, y, name):
        w, b = self.P[f"{name}.weight"], self.P[f"{name}.bias"]
        if not self.train:
            return F.batch_norm(y, self.P[f"{name}.running_mean"],
                                self.P[f"{name}.running_var"], w, b, False,
                                0.0, BN_EPS)
        mean = y.mean((0, 2, 3))
        var = y.var((0, 2, 3), unbiased=False)
        with torch.no_grad():
            m = BN_MOMENTUM
            self.updated[f"{name}.running_mean"] = (
                m * self.P[f"{name}.running_mean"] + (1 - m) * mean)
            self.updated[f"{name}.running_var"] = (
                m * self.P[f"{name}.running_var"] + (1 - m) * var)
        return ((y - mean[:, None, None]) * torch.rsqrt(var + BN_EPS)[:, None,
                                                                     None]
                * w[:, None, None] + b[:, None, None])


def base_conv(x, P, name, bn: BatchNorms, prec, stride=1):
    w = P[f"{name}.conv.weight"]
    k = w.shape[-1]
    return F.silu(bn(conv(x, w, None, stride, (k - 1) // 2, prec),
                     f"{name}.bn"))


def csp(x, P, name, n, bn, prec):
    x1 = base_conv(x, P, f"{name}.conv1", bn, prec)
    x2 = base_conv(x, P, f"{name}.conv2", bn, prec)
    for j in range(n):  # no shortcut in the PAFPN's bottlenecks
        x1 = base_conv(base_conv(x1, P, f"{name}.m.{j}.conv1", bn, prec),
                       P, f"{name}.m.{j}.conv2", bn, prec)
    return base_conv(torch.cat([x1, x2], 1), P, f"{name}.conv3", bn, prec)


def _up2(x):
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def pafpn(feats, P, A, bn, prec):
    x2, x1, x0 = feats  # strides 8, 16, 32, NCHW
    n = csp_depth(A)
    fpn_out0 = base_conv(x0, P, "fpn.lateral_conv0", bn, prec)
    f_out0 = csp(torch.cat([_up2(fpn_out0), x1], 1), P, "fpn.C3_p4", n, bn,
                 prec)
    fpn_out1 = base_conv(f_out0, P, "fpn.reduce_conv1", bn, prec)
    pan_out2 = csp(torch.cat([_up2(fpn_out1), x2], 1), P, "fpn.C3_p3", n, bn,
                   prec)
    p_out1 = base_conv(pan_out2, P, "fpn.bu_conv2", bn, prec, stride=2)
    pan_out1 = csp(torch.cat([p_out1, fpn_out1], 1), P, "fpn.C3_n3", n, bn,
                   prec)
    p_out0 = base_conv(pan_out1, P, "fpn.bu_conv1", bn, prec, stride=2)
    pan_out0 = csp(torch.cat([p_out0, fpn_out0], 1), P, "fpn.C3_n4", n, bn,
                   prec)
    return pan_out2, pan_out1, pan_out0


def anchor_grid(A: dict, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each anchor's grid cell (x, y) [A, 2] and stride [A], level by
    level (strides 8, 16, 32), row-major within a level."""
    H, W = A["in_res_hw"]
    grids, strs = [], []
    for s in (strides(A)[i - 1] for i in A["fpn_in_stages"]):
        h, w = H // s, W // s
        yv, xv = torch.meshgrid(torch.arange(h), torch.arange(w),
                                indexing="ij")
        grids.append(torch.stack([xv, yv], -1).reshape(-1, 2))
        strs.append(torch.full((h * w,), float(s)))
    return (torch.cat(grids).float().to(device),
            torch.cat(strs).to(device))


def head(feats, P, A, bn, prec):
    """Decoded predictions [N, A, 5 + classes]: (cx, cy, w, h) in input
    pixels, then the objectness and class logits."""
    outs = []
    for k, x in enumerate(feats):
        x = base_conv(x, P, f"yolox_head.stems.{k}", bn, prec)
        cls_f, reg_f = x, x
        for j in range(2):
            cls_f = base_conv(cls_f, P, f"yolox_head.cls_convs.{k}.{j}", bn,
                              prec)
            reg_f = base_conv(reg_f, P, f"yolox_head.reg_convs.{k}.{j}", bn,
                              prec)

        def pred(f, name):
            return conv(f, P[f"yolox_head.{name}.{k}.weight"],
                        P[f"yolox_head.{name}.{k}.bias"], 1, 0, prec)

        out = torch.cat([pred(reg_f, "reg_preds"), pred(reg_f, "obj_preds"),
                         pred(cls_f, "cls_preds")], 1)
        N, D = out.shape[:2]
        outs.append(out.permute(0, 2, 3, 1).reshape(N, -1, D))
    out = torch.cat(outs, 1)
    grid, stride = anchor_grid(A, out.device)
    xy = (out[..., :2] + grid) * stride[:, None]
    wh = torch.exp(out[..., 2:4]) * stride[:, None]
    return torch.cat([xy, wh, out[..., 4:]], -1)


def detect(feats_nhwc, P, A, bn: BatchNorms, prec: Precision = F32):
    """PAFPN + head on [N, h, w, C] stage maps (strides 8, 16, 32)."""
    nchw = [f.permute(0, 3, 1, 2) for f in feats_nhwc]
    return head(pafpn(nchw, P, A, bn, prec), P, A, bn, prec)


def raw_head_outputs(preds: torch.Tensor, A: dict) -> torch.Tensor:
    """Decoded predictions back in the head's own units: the box offsets
    (cx / stride - grid x, ...), log(w / stride), log(h / stride), then
    the logits. The space in which the check compares head outputs."""
    grid, stride = anchor_grid(A, preds.device)
    xy = preds[..., :2] / stride[:, None] - grid
    wh = torch.log(preds[..., 2:4] / stride[:, None])
    return torch.cat([xy, wh, preds[..., 4:]], -1)


# --------------------------------------------------------------------------
# Window and state helpers
# --------------------------------------------------------------------------


def zero_states(A: dict, B: int, device) -> Tuple[State, ...]:
    return tuple((torch.zeros(B, h, w, C, device=device),
                  torch.zeros(B, h, w, C, device=device))
                 for (h, w), C in zip(stage_hw(A), stage_dims(A)))


def reset(states, is_first):
    """Zero the states of lanes whose stream restarts."""
    def z(x):
        return torch.where(is_first.reshape(-1, 1, 1, 1),
                           torch.zeros_like(x), x)
    return tuple((z(h), z(c)) for h, c in states)


def pad_events(ev: torch.Tensor, A: dict) -> torch.Tensor:
    """[..., H, W, C] event counts -> float32 zero-padded (bottom, right)
    to ``in_res_hw``."""
    H, W = ev.shape[-3:-1]
    th, tw = A["in_res_hw"]
    return F.pad(ev.float(), (0, 0, 0, tw - W, 0, th - H))


def gather_labelled(valid: torch.Tensor, K: int):
    """The first K labelled frames of each lane, in time order, padded
    with unlabelled ones: (frame index [B, K], labelled [B, K])."""
    order = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)
    idx = order[:, :K]
    return idx, torch.gather(valid, 1, idx)


def gathered(feats, idx):
    """[T, B, h, w, C] maps at frames idx [B, K] -> [B*K, h, w, C]."""
    B, K = idx.shape
    lanes = torch.arange(B, device=idx.device)[:, None]
    return tuple(f.transpose(0, 1)[lanes, idx].reshape(
        (B * K,) + tuple(f.shape[2:])) for f in feats)
