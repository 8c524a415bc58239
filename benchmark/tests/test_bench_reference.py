"""The plain reference against the port's float32 module path at gen1
tiny on the CPU: an eval window, three train steps, raw calls. Each cell
of ``tiny32.<kind>`` runs the port's entry through a short window and
then the check; both sides compute in float32, so every number the check
compares is at the level of float32 rounding (summation order, the
port's fast-variance LayerNorm and BatchNorm)."""
import math
import time

import pytest

from benchmark.core.cell import run_cell
from benchmark.tests.tiny import KINDS, tiny_copy

F32_GAP = 2e-3  # float32 against float32: rounding and summation order


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("kind", KINDS)
def test_reference_matches_port_f32(manifest, kind):
    r = run_cell(f"tiny32.{kind}", 2 ** 31 + 5, 0.3, False,
                 t_start=time.perf_counter(), device="cpu",
                 manifest=manifest, log=lambda *a: None)
    assert r["attempted"] > 0 and r["failed"] == 0
    for name, c in r["checks"].items():
        assert math.isfinite(c["value"]) and c["value"] <= F32_GAP, (name, c)
