"""Mixed-precision helpers: the port's counterpart of
``rvt_tpu/utils/precision.py``.

Policy: precision follows dtype (the float32 pin is in
``rvt_tpu_torch/__init__.py``: no TF32). The bf16 serving path casts
parameters and activations to bfloat16; BatchNorm running statistics
stay float32, attention logits and the box decode are computed in
float32 inside the modules."""
from __future__ import annotations

from typing import Dict

import torch

# a BatchNorm's buffers in a state dict (flax's batch_stats collection)
BN_STATS = ("running_mean", "running_var", "num_batches_tracked")


def cast_params_bf16(state: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """A copy of a model's ``state_dict`` with every floating parameter in
    bf16 and the BatchNorm statistics (the ``batch_stats`` JAX keeps in
    f32) and non-floating tensors as they are."""
    return {k: (v.to(torch.bfloat16)
                if v.is_floating_point() and not k.endswith(BN_STATS)
                else v)
            for k, v in state.items()}
