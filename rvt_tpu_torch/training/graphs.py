"""Each step as one captured CUDA graph: the port's counterpart of
``jax.jit``.

The JAX package runs each step (``rvt_tpu/training/step.py:203`` the
train step, ``:300`` the eval step, ``rvt_tpu/inference.py:83`` the raw
step) as one compiled program. The port's steps are Python that launches
thousands of kernels a call; ``CapturedStep`` records those launches once
as a CUDA graph and replays it, so that the host no longer paces the card.

On the first call per signature (the shapes, dtypes and devices of the
tensor arguments, the other arguments' values and which optional ones are
given: the analogue of a retrace) the step runs once eagerly on the
capture stream. That warm-up is the call's result, and it makes the
kernels' one-time host work (``cudaFuncSetAttribute``, occupancy queries,
tensor-map encoders, cuBLAS workspaces) happen outside any capture. Then
the step is captured into static input buffers, and every later call
copies its tensors into them, replays the graph and returns copies of the
static outputs, so that each call's results outlive the next call as
eager results do. The step bodies read nothing back from the device (a
host read inside a capture raises); host work a step needs before its
kernels (the optimizer's scalars) runs in ``before``, outside the graph,
at every call.

A capture that fails raises: there is no eager fallback on a card. On
the CPU, and inside ``eager()``, the step runs eagerly. A data-parallel
train step's NCCL collectives are captured with its kernels: the warm-up
runs them first, outside the capture, which makes the communicator.
Gloo's collectives stage through the host and cannot be captured, so
``make_train_step`` gives a gloo step to no capture: it runs eagerly,
chosen from the backend.

Each kernel's launch ``Counter`` counts the launches of a capture; the
capture's counts are taken back, and every replay credits them again.

Tracing (``utils/timers.py``): a call is the span ``step``, with
``step.before``, ``step.copy_in``, ``step.replay`` and ``step.copy_out``
(or ``step.eager`` for an eager run) inside it, and the counter
``launches`` (the hand-written kernels' launches it made or a replay
credits). The step body's layer marks (``timers.mark``) are captured
into each graph whatever the switch says, as kernel nodes that write the
card's clock into the graph's ring (``timers.Captured``), one row a
replay; the traced replays' rows are read in one copy when the ring comes
round, or by ``timers.summary()``, and no call waits for a replay.

The graphs of one ``CapturedStep`` share one memory pool, and steps may
share theirs (the Trainer's variants): the graphs then reuse each other's
intermediates, which is safe because the port's steps replay one at a time
on one stream, and each replay's outputs are copied before another graph
runs. The kernels' workspaces (``ops/voxelization.py:_hist_workspace``,
``ops/fused_attention.py:_reduce_workspace``) are shared by every graph
on the same terms and are never freed while the process lives
(``kernels.retire``).
"""
from __future__ import annotations

import contextlib
import gc
from typing import Callable, Dict, Optional

import torch
from torch.utils import _pytree as pytree

from rvt_tpu_torch.ops.kernels import COUNTERS, TALLIES
from rvt_tpu_torch.utils import timers

_EAGER = [False]
_CAPTURE_STREAMS: Dict[int, torch.cuda.Stream] = {}


@contextlib.contextmanager
def eager():
    """Within this block every ``CapturedStep`` runs eagerly on the
    current stream: the reference a replay is held against, bit for bit."""
    prev = _EAGER[0]
    _EAGER[0] = True
    try:
        yield
    finally:
        _EAGER[0] = prev


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """One capture stream a device: the warm-ups run there too, so that
    per-stream lazy state (cuBLAS workspaces) exists before a capture."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[index] = torch.cuda.Stream(index)
    return _CAPTURE_STREAMS[index]


def signature(leaves, spec) -> tuple:
    """What a graph is specific to: the argument tree, each tensor's
    shape, dtype and device, and every other leaf's value."""
    return (spec, tuple(
        (tuple(x.shape), x.dtype, x.device) if isinstance(x, torch.Tensor)
        else ("value", x) for x in leaves))


class _Graph:
    def __init__(self, graph, static_in, static_out, credit, layers):
        self.graph = graph
        self.static_in = static_in    # leaves; tensors at fixed addresses
        self.static_out = static_out  # the body's outputs, rewritten a replay
        self.credit = credit          # Counter -> launches a replay
        self.launches = sum(n for c, n in credit.items() if not c.tally)
        self.layers = layers          # the body's marks: timers.Captured


def _launches() -> int:
    return sum(c.launches for c in COUNTERS)


def _card(leaves) -> Optional[torch.device]:
    for x in leaves:
        if isinstance(x, torch.Tensor) and x.is_cuda:
            return x.device
    return None


def _copy_out(tree):
    return pytree.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)


class CapturedStep:
    """``fn(*args, **kwargs)``, captured as a CUDA graph per signature when
    its tensors lie on a card; ``before()`` runs at every call, before the
    step's kernels and outside the graph. ``pool`` (a
    ``torch.cuda.graph_pool_handle()``) is the memory pool the graphs
    share, made on the first capture when None."""

    def __init__(self, fn: Callable, *, before: Optional[Callable] = None,
                 pool=None):
        self.fn = fn
        self.before = before
        self.pool = pool
        self.graphs: Dict[tuple, _Graph] = {}

    def run_eager(self, *args, **kwargs):
        """The step as plain Python on the current stream."""
        timers.next_call()
        with timers.span("step"):
            return self._eager(args, kwargs)

    def _before(self, device) -> None:
        if self.before is not None:
            with timers.span("step.before", device):
                self.before()

    def _eager(self, args, kwargs):
        device = _card(pytree.tree_leaves((args, kwargs))) \
            if timers.on() else None
        self._before(device)
        return self._body(args, kwargs, device)

    def _body(self, args, kwargs, device):
        """The body, eagerly; traced, with its layers and launches."""
        if not timers.on():
            return self.fn(*args, **kwargs)
        n = _launches()
        with timers.span("step.eager", device) as sp:
            with timers.layers(device) as marks:
                out = self.fn(*args, **kwargs)
            timers.queue_layers(marks, sp.rec)
        timers.add_count("launches", _launches() - n)
        return out

    def __call__(self, *args, **kwargs):
        timers.next_call()
        with timers.span("step"):
            return self._call(args, kwargs)

    def _call(self, args, kwargs):
        leaves, spec = pytree.tree_flatten((args, kwargs))
        tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
        on_card = [t.is_cuda for t in tensors]
        if _EAGER[0] or not any(on_card):
            return self._eager(args, kwargs)
        if not all(on_card):
            raise ValueError("a captured step takes its tensors on one card "
                             "(got CPU and CUDA tensors)")
        device = tensors[0].device
        key = signature(leaves, spec)
        graph = self.graphs.get(key)
        self._before(device)
        if graph is None:
            out = self._warm_up(args, kwargs, device)
            self.graphs[key] = self._capture(leaves, spec, device)
            return out
        with timers.span("step.copy_in", device):
            for dst, src in zip(graph.static_in, leaves):
                if isinstance(dst, torch.Tensor):
                    dst.copy_(src)
        graph.layers.before_replay()
        with timers.span("step.replay") as sp:
            graph.graph.replay()
        graph.layers.after_replay(sp.rec, device)
        for counter, n in graph.credit.items():
            counter.launches += n
        if sp.rec is not None:
            timers.add_count("launches", graph.launches)
        with timers.span("step.copy_out", device):
            return _copy_out(graph.static_out)

    def _warm_up(self, args, kwargs, device):
        stream = _capture_stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            out = self._body(args, kwargs, device)
        torch.cuda.current_stream(device).wait_stream(stream)
        return out

    def _capture(self, leaves, spec, device) -> _Graph:
        static_in = [torch.empty_like(x) if isinstance(x, torch.Tensor)
                     else x for x in leaves]
        args, kwargs = pytree.tree_unflatten(static_in, spec)
        counts = {c: c.launches for c in COUNTERS + TALLIES}
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        stream = _capture_stream(device)
        layers = timers.Captured(stream)
        # An unreachable step's graph destroyed during the capture (by the
        # cyclic collector, which may run at any allocation) would break
        # it: collect now, and not again until the capture has ended.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            # thread_local: only this thread's unsafe calls break the
            # capture; other threads (the Trainer's prefetch thread, loader
            # threads) may call CUDA meanwhile.
            with torch.cuda.graph(graph, pool=self.pool, stream=stream,
                                  capture_error_mode="thread_local"):
                with layers:
                    static_out = self.fn(*args, **kwargs)
        finally:
            if collecting:
                gc.enable()
            credit = {c: c.launches - n for c, n in counts.items()
                      if c.launches != n}
            for c in credit:  # nothing ran: a replay launches them
                c.launches = counts[c]
        return _Graph(graph, static_in, static_out, credit, layers)
