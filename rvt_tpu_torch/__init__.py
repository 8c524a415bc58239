"""rvt_tpu_torch: the PyTorch + CUDA port of rvt_tpu for NVIDIA Hopper.

It mirrors the JAX package's layout (``config``, ``models/``, ``ops/``,
``training/step.py``, ``convert/``) and imports nothing of it: what it
needs from there it keeps as its own copy. The serving hot path runs on
hand-written CUDA kernels (``csrc/*.cu``, built at first use by
``ops/kernels.py``); each has a plain PyTorch version beside it, which
the wrappers take for tensors on the CPU.

Entry points take a ``device`` argument that defaults to ``"cuda"`` and
raise when no card is present; pass ``device="cpu"`` to run the plain
versions on the host (the tests do).
"""

__version__ = "0.1.0"

import torch as _torch

# Precision follows dtype, as in the JAX package's float32 pin: float32
# matmuls and convolutions (the head's prediction convs, the plain
# versions' products) run in true float32, never in TF32. cuDNN allows
# TF32 convolutions by default.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> _torch.device:
    """``device`` as a ``torch.device``; raises when it names a CUDA card
    and none is present (entry points never fall back to the CPU)."""
    d = _torch.device(device)
    if d.type == "cuda" and not _torch.cuda.is_available():
        raise RuntimeError(
            "rvt_tpu_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch versions on the host")
    return d
