"""On a card, at each cell's own size: the control (the reference with
float8 operands in the program's place, on the same inputs) fails the
cell's check on three seeds, and the program passes it on the same
seeds. ``calibrate.py`` takes the readings the limits are set from."""
import gc

import pytest
import torch

from benchmark.core.cell import judge
from benchmark.core.loop import timed_window
from benchmark.core.manifest import Manifest

CELLS = ("rvtb_gen1.window_eval", "rvts_gen1.tbptt_train",
         "rvtb_gen1.tbptt_train", "rvtb_gen1.raw_stream")
SEEDS = (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_program_passes(card, cell, seed):
    m = Manifest()
    wl = m.workload(cell)
    d = m.traffic(wl["traffic"]).Driver(m.config(wl["config"]), wl, seed,
                                        card)
    d.setup(2.0)
    timed_window(d.call, d.finish, 2.0, card)
    d.release()
    gc.collect()
    torch.cuda.empty_cache()
    readings, control = d.check(control=True)
    assert judge(readings, wl["limits"])[0], readings
    # the control fails on a number it reads, not on one it lacks
    assert not judge(control, {k: v for k, v in wl["limits"].items()
                               if k in control})[0], control
