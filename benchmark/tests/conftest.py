"""The benchmark's own tests. On the CPU: the reference against the
port's float32 module path at gen1 tiny, the frozen counts, discovery by
name, the import guard, the trace reader and the checks' faults. On a
card (marker ``cuda``): the control at each cell's own size.

    python -m pytest benchmark/tests -q            # here: the card tests skip
    python -m pytest benchmark/tests -q -m cuda    # on a card
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    """The card a ``cuda`` test runs on; skips without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
