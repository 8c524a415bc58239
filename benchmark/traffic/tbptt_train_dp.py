"""TBPTT training over data-parallel ranks: ``tbptt_train``'s steps, pool
and check, with the global batch of ``lanes`` split over ``ranks``
processes, one a card, over NCCL (gloo on the CPU), through the port's
``parallel/mesh.py``.

Rank 0 is the harness's process, on the first card. Set-up starts ranks 1
to ``ranks - 1`` (``python -m benchmark.traffic.tbptt_train_dp SPEC
RANK``), each on its own card. Every rank builds the same global pool and
the same weights from the seed (broadcast from rank 0 besides, as the
Trainer does) and the captured train step with the group
(``make_train_step(..., group=)``), which computes the step over the
global batch: the foreground and GT counts summed, BatchNorm's moments
averaged over the ranks, one flat gradient all-reduce, the loss parts
summed. Each rank steps its own lanes (``DataParallel.lanes``).

Pacing: rank 0 writes each command (a call, the window's end, the run's
end) under the next key of the process group's store; every other rank
waits on that key and runs the command, so that each runs exactly the
calls rank 0 runs. The timed step holds the step's own collectives and
nothing else. ``frames_per_call`` counts the global batch;
``flops_per_call`` and ``bound_per_call`` rank 0's lanes, so that the
shares read one card's work over one card's peak.

The check is ``tbptt_train``'s on the global batch: rank 0's losses,
gradient norms and first gradient are the global step's, its leaves and
BatchNorm buffers are every rank's, and the final states are gathered
from every rank at set-up, outside the window. One more reading,
``replica_mismatch``: 1 where any rank's parameters or buffers after step
3 differ from rank 0's, bit for bit.

A rank that dies or stops answering ends the run with ``failed`` above 0
and never hangs the harness: rank 0 runs at most ``DEPTH`` calls ahead of
its card and waits for the oldest within ``STALL_S`` seconds, looking at
the other ranks' processes meanwhile; on a loss it aborts the process
group, which frees its card's collectives. At the end every rank frees
its captured graphs and leaves the group at once (``leave``), and
``release()`` joins the ranks within ``JOIN_S`` seconds and kills what is
left.
"""
from __future__ import annotations

import gc
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist

from benchmark.counts import bounds, flops
from benchmark.traffic import tbptt_train

ROOT = Path(__file__).resolve().parents[2]
DEPTH = 4         # calls rank 0 runs ahead of its card
STALL_S = 120.0   # longest wait for the ranks' start, a call or a report
JOIN_S = 60.0     # release's wait for the ranks to exit
KEY = "bench_dp/"


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def leave(lost: bool) -> None:
    """Leave the process group: with every rank at once
    (``destroy_process_group``, which on NCCL waits for the others), or
    after a rank was lost by aborting the communicators, so that
    collectives on the card end instead of waiting for it. The caller
    frees its captured graphs first: NCCL holds a communicator while a
    graph that captured its collectives lives. A teardown that does not
    end within ``JOIN_S`` seconds ends the process."""
    from torch.distributed import distributed_c10d as c10d

    if not dist.is_initialized():
        return
    stuck = threading.Timer(JOIN_S, _stuck)
    stuck.daemon = True
    stuck.start()
    try:
        gc.collect()
        if not lost:
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            dist.destroy_process_group()
            return
        try:
            c10d._abort_process_group()
        except Exception as e:  # a backend without abort
            print(f"tbptt_train_dp: abort: {e}", file=sys.stderr, flush=True)
            if dist.is_initialized():
                dist.destroy_process_group()
    finally:
        stuck.cancel()


def _stuck() -> None:
    print(f"tbptt_train_dp: leaving the process group took over {JOIN_S} s",
          file=sys.stderr, flush=True)
    os._exit(5)


class Driver(tbptt_train.Driver):
    def __init__(self, cfg: dict, wl: dict, seed: int, device, rank: int = 0):
        super().__init__(cfg, wl, seed, device)
        self.rank = rank
        self.procs, self.logs, self.tmp = [], [], None
        self.k = 0          # the next command's key
        self.lost = None    # why a rank was lost
        self.pending = deque()

    # ------------------------------------------------------------ set-up

    def setup(self, seconds: float) -> None:
        from rvt_tpu_torch.models.backbone import zero_states
        from rvt_tpu_torch.parallel.mesh import (init_process_group,
                                                 make_mesh, module_tensors,
                                                 replicate_tree,
                                                 same_on_all_ranks)
        from rvt_tpu_torch.training.optimizer import make_optimizer
        from rvt_tpu_torch.training.step import make_train_step

        from benchmark.core.port import port_config, port_model

        tp, A = self.tp, self.A
        if self.rank == 0:
            if self.device.type == "cuda":
                from rvt_tpu_torch.ops import kernels
                kernels.build_all()  # once, before the other ranks start
            init = f"tcp://127.0.0.1:{free_port()}"
            self._spawn(init, seconds)
            self._await_ranks()
            self.device = init_process_group(
                self.device.type, init_method=init, rank=0,
                world_size=tp["ranks"])
        self.mesh = make_mesh()
        self.store = dist.distributed_c10d._get_default_store()
        dev = self.device
        self.B, self.T = tp["lanes"], A["sequence_length"]
        self.K = A["max_labeled_frames"]
        self.lanes = self.mesh.lanes(self.B)
        n = self.lanes.stop - self.lanes.start
        self.frames_per_call = self.B * self.T
        self.flops_per_call = flops.train_step(A, n, self.T, self.K)
        self.pc = port_config(self.cfg, stem_s2d=False)
        self.sd = self.weights()
        self.model = port_model(self.pc, self.sd, dev)
        replicate_tree(self.mesh, module_tensors(self.model))
        self.opt = make_optimizer(self.model.parameters(), self.pc.training)
        self.step = make_train_step(self.model, self.pc, self.opt,
                                    group=self.mesh.group)
        self.pool = [self._batch(j) for j in range(tp["pool_batches"])]
        n_max = int(seconds * 200) + 64
        first = torch.from_numpy(self.rng.random((n_max, self.B))
                                 < tp["restart_p"])
        first[0] = True
        self.is_first = first.to(dev)
        self.states = zero_states(self.pc.model.backbone, n, device=dev)
        self.nonfinite = torch.zeros((), dtype=torch.int64, device=dev)
        names = [name for name, _ in self.model.named_parameters()]
        self.first = []
        for s in range(tbptt_train.FIRST):
            m = self._step(s, s)
            self.first.append({k: float(v) for k, v in m.items()})
            if s == 0:
                self.g1 = {name: mu.detach().clone() / (1 - tbptt_train.B1)
                           for name, mu in zip(names, self.opt.mu)}
        self.p3 = {name: p.detach().clone()
                   for name, p in self.model.named_parameters()}
        self.b3 = {name: b.detach().clone()
                   for name, b in self.model.named_buffers()}
        self.s3 = self._gather(self.states)
        self.replicas = same_on_all_ranks(self.mesh,
                                          module_tensors(self.model))
        self.offset = tbptt_train.FIRST

    def _spawn(self, init: str, seconds: float) -> None:
        """Start ranks 1 to ranks - 1, each with the cell's files and the
        group's address in a spec beside its log."""
        self.tmp = Path(tempfile.mkdtemp(prefix="rvt_bench_dp_"))
        spec = self.tmp / "spec.json"
        spec.write_text(json.dumps({
            "cfg": self.cfg, "wl": self.wl, "seed": self.seed,
            "seconds": seconds, "device": self.device.type, "init": init,
            "world": self.tp["ranks"], "parent": os.getpid()}))
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
            [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        for r in range(1, self.tp["ranks"]):
            log = self.tmp / f"rank{r}.log"
            with open(log, "w") as f:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", "benchmark.traffic.tbptt_train_dp",
                     str(spec), str(r)], stdout=f, stderr=subprocess.STDOUT,
                    env=env, cwd=str(ROOT)))
            self.logs.append(log)

    def _await_ranks(self) -> None:
        """Wait until every rank is about to join the group, so that rank
        0 joins it only with ranks that are there; a rank that exits or
        does not come within ``STALL_S`` raises, with its log."""
        deadline = time.monotonic() + STALL_S
        while not all((self.tmp / f"rank{r}.ready").exists()
                      for r in range(1, self.tp["ranks"])):
            r = self._dead()
            if r is not None or time.monotonic() > deadline:
                self._kill()
                raise RuntimeError(
                    f"rank {r} exited before joining the group"
                    if r is not None else f"the ranks did not start within "
                    f"{STALL_S} s" + "\n" + self._tails())
            time.sleep(0.05)

    def _tails(self) -> str:
        return "\n".join(
            f"--- {log.name}\n" + "\n".join(
                log.read_text(errors="replace").splitlines()[-20:])
            for log in self.logs)

    def _kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        self.procs = []
        shutil.rmtree(self.tmp, ignore_errors=True)

    def _gather(self, states):
        """Every rank's lanes of ``states``, in lane order."""
        if self.mesh.world == 1:
            return states
        out = []
        for hc in states:
            pair = []
            for x in hc:
                parts = [torch.empty_like(x) for _ in range(self.mesh.world)]
                dist.all_gather(parts, x.contiguous(), group=self.mesh.group)
                pair.append(torch.cat(parts))
            out.append(tuple(pair))
        return tuple(out)

    def bound_per_call(self) -> float:
        n = self.lanes.stop - self.lanes.start
        return bounds.train_step(self.A, n, self.T)

    def _step(self, s: int, j: int):
        ev, labels, mask, fv = self.pool[j % len(self.pool)]
        sl = self.lanes
        self.states, m = self.step(self.states, ev[sl], labels[sl], mask[sl],
                                   fv[sl], self.is_first[s][sl])
        self.nonfinite += (~torch.isfinite(m["loss"])).long()
        return m

    # ------------------------------------------------------------ window

    def _tell(self, cmd: str) -> None:
        self.store.set(f"{KEY}{self.k}", cmd)
        self.k += 1

    def _dead(self):
        """The first rank whose process has exited, or None."""
        for r, p in enumerate(self.procs, 1):
            if p.poll() is not None:
                return r
        return None

    def _lose(self, why: str) -> None:
        self.lost = why
        print(f"tbptt_train_dp: {why}\n{self._tails()}", file=sys.stderr,
              flush=True)
        self.step = None  # the graphs first, then the communicators
        leave(lost=True)

    def _wait(self, ev) -> bool:
        """Wait for ``ev`` on the card, looking at the other ranks."""
        deadline = time.monotonic() + STALL_S
        while not ev.query():
            r = self._dead()
            if r is not None or time.monotonic() > deadline:
                self._lose(f"rank {r} exited" if r is not None else
                           f"a call waited {STALL_S} s on the card")
                return False
            time.sleep(1e-4)
        return True

    def call(self, i: int) -> None:
        if self.lost:
            return
        r = self._dead()
        if r is not None:
            self._lose(f"rank {r} exited")
            return
        self._tell("call")
        s = self.offset + i
        try:
            self._step(s, s)
        except RuntimeError as e:  # a gloo collective that timed out
            self._lose(f"call {i} raised: {e}")
            return
        self.attempted += 1
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            self.pending.append(ev)
            if len(self.pending) > DEPTH:
                self._wait(self.pending.popleft())

    def finish(self) -> None:
        """Wait for the card and for every rank to report the calls it
        ran; a rank that ran another number of calls is a failure."""
        while self.pending and not self.lost:
            self._wait(self.pending.popleft())
        if self.lost:
            # the card is freed by the abort, or the run cannot go on
            done = torch.cuda.Event() if self.device.type == "cuda" else None
            if done is not None:
                done.record()
                deadline = time.monotonic() + STALL_S
                while not done.query():
                    if time.monotonic() > deadline:
                        print("tbptt_train_dp: the card did not come free "
                              "after the abort", file=sys.stderr, flush=True)
                        os._exit(4)
                    time.sleep(1e-3)
            self.failed = 1
            return
        self._tell("finish")
        keys = [f"{KEY}done/{r}" for r in range(1, self.mesh.world)]
        try:
            self.store.wait(keys, timedelta(seconds=STALL_S))
            ran = [int(self.store.get(k)) for k in keys]
        except RuntimeError as e:
            self._lose(f"the ranks did not report their calls: {e}")
            self.failed = 1
            return
        self.failed = int(self.nonfinite) + sum(
            n != self.attempted for n in ran)

    def release(self) -> None:
        """Stop the other ranks; every rank frees its step (its captured
        graphs) and leaves the group at once; rank 0 then joins them."""
        if self.rank == 0 and self.procs and not self.lost:
            self._tell("stop")
        super().release()
        leave(bool(self.lost))
        if self.rank == 0 and self.procs:
            deadline = time.monotonic() + JOIN_S
            for r, p in enumerate(self.procs, 1):
                try:
                    p.wait(max(0.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
                if p.returncode != 0 and not self.lost:
                    self._lose(f"rank {r} ended with {p.returncode}")
                    self.failed += 1
            self._kill()

    # ------------------------------------------------------------- check

    def check(self, control: bool = False, extra=()):
        readings, cread = super().check(control, extra)
        readings["replica_mismatch"] = 0.0 if self.replicas else 1.0
        return readings, cread


# ---------------------------------------------------------------- ranks


def _command(d: Driver) -> str:
    """The next command (waiting for it)."""
    cmd = d.store.get(f"{KEY}{d.k}").decode()
    d.k += 1
    return cmd


def _watch(parent: int) -> None:
    """End this rank once rank 0's process is gone."""
    while os.getppid() == parent:
        time.sleep(1.0)
    os._exit(3)


def rank_main(argv) -> int:
    """Rank ``RANK`` of the cell in ``SPEC``: join the group, set up as
    rank 0 does, then run rank 0's commands until ``stop``."""
    from rvt_tpu_torch.parallel.mesh import init_process_group

    spec_path, rank = argv[0], int(argv[1])
    torch.set_num_threads(1)
    spec = json.loads(Path(spec_path).read_text())
    threading.Thread(target=_watch, args=(spec["parent"],),
                     daemon=True).start()
    (Path(spec_path).parent / f"rank{rank}.ready").touch()
    device = init_process_group(spec["device"], init_method=spec["init"],
                                rank=rank, world_size=spec["world"])
    d = Driver(spec["cfg"], spec["wl"], spec["seed"], device, rank=rank)
    d.setup(spec["seconds"])
    i = 0
    while True:
        cmd = _command(d)
        if cmd == "call":
            s = d.offset + i
            d._step(s, s)
            i += 1
        elif cmd == "finish":
            if d.device.type == "cuda":
                torch.cuda.synchronize(d.device)
            d.store.set(f"{KEY}done/{rank}", str(i))
        elif cmd == "stop":
            break
        else:
            raise ValueError(f"unknown command {cmd!r}")
    d.release()
    return 0


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1:]))
