"""No module loaded by the harness, a traffic driver, the reference or
the port they drive has the top-level name of JAX, flax or the JAX
package (``rvt_tpu``; the port's ``rvt_tpu_torch`` begins with it, so the
names are compared whole). A fresh interpreter imports every part and
runs a tiny cell of each kind on the CPU."""
import json
import subprocess
import sys

from benchmark.core.manifest import ROOT

PROBE = r"""
import sys, time, json, pathlib
sys.path.insert(0, {root!r})
from benchmark.tests.tiny import KINDS, tiny_copy
from benchmark.core.cell import forbidden_modules, run_cell
import benchmark.run, benchmark.calibrate
import benchmark.reference.rvt, benchmark.reference.train
import benchmark.reference.post
m = tiny_copy(pathlib.Path({tmp!r}))
for spec in m.spec["per_layer"] + m.spec["end_to_end"]:
    m.reader(spec["name"])
for kind in KINDS:
    m.traffic(kind)
    run_cell("tiny." + kind, 3, 0.2, False, t_start=time.perf_counter(),
             device="cpu", manifest=m, log=lambda *a: None)
print(json.dumps({{"forbidden": forbidden_modules(),
                   "port": "rvt_tpu_torch" in sys.modules}}))
"""


def test_no_jax_loaded(tmp_path):
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(ROOT),
                                            tmp=str(tmp_path))],
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"forbidden": [], "port": True}


def test_forbidden_names_compare_whole():
    from benchmark.core.cell import forbidden_modules

    assert forbidden_modules(["rvt_tpu_torch", "rvt_tpu_torch.ops",
                              "jaxtyping", "flaxen.x"]) == []
    assert forbidden_modules(["rvt_tpu.ops", "jaxlib.xla", "flax",
                              "jax"]) == ["flax", "jax", "jaxlib", "rvt_tpu"]
