"""The compiled-call layer: one search program, compiled once per batch
shape — the port's counterpart of the reference's ``jax.jit`` of a search
(``repro.core.engine``'s ``_get_fn``).

A search is a *program* (``core/traversal.py``): Python that yields each
loop it runs to convergence.  ``compile_program`` turns one into a callable
with fixed input shapes:

* on the CPU, a plain callable that runs the program eagerly
  (``EagerProgram``);
* on ``cuda``, CUDA graphs (``GraphedProgram``): one graph for the code
  before, between and after the loops, and for each loop one graph of
  ``traversal.CHUNK`` rounds (plus one of the rounds that remain where
  ``max_rounds`` is not a multiple of it), replayed until a device flag says
  the batch has converged — one host sync per chunk, as the eager loop
  (``traversal.run_to_convergence``) makes.  Where the reference's
  ``lax.while_loop`` tests on the device after every round, the port tests
  on the host after every chunk; the rounds past convergence are fixed
  points, so the results are the same.

There is no fallback: a capture or replay that fails raises with the CUDA
error, and nothing on ``cuda`` runs eagerly unless it is called eagerly on
purpose (``multistage.multistage_search`` and friends).

What a call records (``runtime/trace.py``):

* Counters.  A kernel wrapper counts its launches in Python, which a
  replay does not run: the launches counted while a graph is captured are
  taken off the counters again (a capture launches nothing), remembered
  per graph, and added at every replay, so ``kernels.launch_counts()``
  counts what ran on the card either way.  Each host test of a loop adds
  to ``search.host_tests`` and each chunk it runs to ``search.rounds``, as
  the eager loop counts them.
* Stage timings.  Every graph records a timing event (an event-record
  node, ``torch.cuda.Event(enable_timing=True, external=True)``) at its
  start, at each ``traversal.Stage`` marker the program yields inside it,
  and at its end; a marker splits no graph.  Every replay queues its
  events, and the tracer adds each stretch between two of them to its
  stage's ``<stage>.device_ns`` once the device has run it.  A stage's
  device time is then the sum of its stretches across every graph it
  spans (a looped stage: its set-up in the segment before its loop, every
  chunk of the loop, and the segment after); the launch gaps between
  graphs are in none.  Nothing here waits on the device for them.
* Spans (tracing on): ``repro_torch.search`` around a call; inside it one
  span per step, named after the stage in effect where the step starts
  (a segment that holds several stages, as the first one of a multi-stage
  search does, is named after its first: its stages cannot be parted on
  the host); ``<stage>.test`` around each host test.  A program that marks
  no stage has neither step nor test spans.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch import kernels
from repro_torch.core import traversal as T
from repro_torch.runtime import trace


def compile_program(program: Callable[..., T.Program],
                    inputs: Sequence[torch.Tensor]):
    """``program(*inputs)`` compiled for the shapes, dtypes and device of
    ``inputs``: a ``GraphedProgram`` on ``cuda`` (captured now), else an
    ``EagerProgram``."""
    if inputs[0].device.type == "cuda":
        return GraphedProgram(program, inputs)
    return EagerProgram(program)


def _warm_up(gen: T.Program) -> None:
    """Run a program eagerly, with one extra round at the start of each loop
    (a fixed point where the batch has converged): every kernel a capture
    records has then run once."""
    try:
        item = next(gen)
        while True:
            if isinstance(item, T.Stage):
                item = gen.send(None)
                continue
            if item.max_rounds:
                item.round_fn(item.state)
            item = gen.send(T.run_to_convergence(*item))
    except StopIteration:
        pass


class EagerProgram:
    """A program run eagerly at every call (the CPU's compiled call)."""

    def __init__(self, program: Callable[..., T.Program]):
        self.program = program

    def __call__(self, *inputs):
        with torch.no_grad(), trace.span("search"):
            return T.run_program(self.program(*inputs))


class _Graph:
    """One captured graph: the kernel launches it holds, its timing, and
    the stage its host span is named after (a stretch between loops; none
    for a loop's chunk, which runs inside the loop's span).  The timing
    holds the events the graph records, so they live as long as it does."""

    def __init__(self, graph: torch.cuda.CUDAGraph, launches: Dict[str, int],
                 timing: trace.Timing, span: Optional[str] = None):
        self.graph, self.launches = graph, launches
        self.timing, self.span = timing, span

    def replay(self) -> None:
        trace.settle(self.timing)
        with trace.span(self.span):
            self.graph.replay()
        kernels.add_launch_counts(self.launches)
        trace.timed(self.timing)


class _CapturedLoop:
    """A captured convergence loop of ``stage``: ``graphs[m]`` runs m rounds
    in place on the loop's state and then sets ``flag`` to whether work is
    left."""

    def __init__(self, max_rounds: int, chunk: int, flag: torch.Tensor,
                 graphs: Dict[int, _Graph], stage: Optional[str]):
        self.max_rounds, self.chunk = max_rounds, chunk
        self.flag, self.graphs, self.stage = flag, graphs, stage

    def replay(self) -> None:
        stage = self.stage
        with trace.span(stage):
            for m in T.chunk_sizes(self.max_rounds, self.chunk):
                trace.count("search.host_tests")
                with trace.span(stage and f"{stage}.test"):
                    work = bool(self.flag)
                if not work:
                    break
                self.graphs[m].replay()
                trace.count("search.rounds", m)


class GraphedProgram:
    """A program captured as CUDA graphs at the shapes of ``inputs``.

    Calling it copies the arguments into the static input buffers, replays
    the graphs and returns the static outputs, which the next call
    overwrites: read or copy them before calling again.  One memory pool
    holds every graph's tensors; the graphs replay in the order they were
    captured (a loop's chunks in place), so they may share it.  The host
    tests and rounds of a call are the deltas of ``search.host_tests`` and
    ``search.rounds`` over it (module docstring)."""

    def __init__(self, program: Callable[..., T.Program],
                 inputs: Sequence[torch.Tensor]):
        self.chunk = T.CHUNK
        self.inputs = [x.detach().clone() for x in inputs]
        self.pool = torch.cuda.graph_pool_handle()
        self.steps: List = []
        dev = self.inputs[0].device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.no_grad():
            # eager warm-up: builds the kernels, opts them in to their
            # shared memory and makes the library handles, none of which a
            # capture may do
            with torch.cuda.stream(side):
                _warm_up(program(*self.inputs))
            torch.cuda.current_stream(dev).wait_stream(side)
            self._capture(program(*self.inputs), side)

    def _graph(self, side: torch.cuda.Stream, body: Callable,
               stage: Optional[str]):
        """Capture ``body(mark)`` into a new graph that records a timing
        event at its start (of ``stage``, the one in effect), at each
        ``mark(stage)`` the body makes, and at its end: ``(_Graph, body's
        result)``."""
        graph = torch.cuda.CUDAGraph()
        marks = []

        def mark(name: Optional[str]) -> None:
            ev = torch.cuda.Event(enable_timing=True, external=True)
            ev.record()
            marks.append((name, ev))

        # the registry as it stands, without folding in timings the device
        # finishes meanwhile: only what the capture counted is taken back
        before = trace.counts(fold_timings=False)
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=side):
                mark(stage)
                out = body(mark)
                mark(None)
        except RuntimeError as e:
            raise RuntimeError(f"CUDA graph capture of a search program "
                               f"failed: {e}") from e
        finally:
            after = trace.counts(fold_timings=False)
            launches = {k: n - before.get(k, 0) for k, n in after.items()
                        if n != before.get(k, 0)}
            kernels.add_launch_counts({k: -v for k, v in launches.items()})
        return _Graph(graph, launches, trace.Timing(marks)), out

    def _capture(self, gen: T.Program, side: torch.cuda.Stream) -> None:
        sent, stage = None, None
        while True:
            def segment(mark, sent=sent):
                nonlocal stage
                try:
                    item = gen.send(sent)
                    while isinstance(item, T.Stage):
                        stage = item.name
                        mark(stage)
                        item = gen.send(None)
                except StopIteration as done:
                    return None, done.value
                # the loop's own buffers (a state may hold one tensor in two
                # fields, which in-place rounds would tie together)
                state = T.SearchState(*(t.clone() for t in item.state))
                return item._replace(state=state), T.pending(state, item.n)

            first = stage
            graph, (loop, out) = self._graph(side, segment, stage)
            graph.span = first or next(
                (s for s in graph.timing.stages if s), None)
            self.steps.append(graph)
            if loop is None:
                self.outputs = out
                return
            flag = out
            graphs = {}
            for m in sorted(set(T.chunk_sizes(loop.max_rounds, self.chunk))):
                graphs[m], _ = self._graph(
                    side, lambda mark, m=m: self._rounds(loop, flag, m),
                    stage)
            self.steps.append(_CapturedLoop(loop.max_rounds, self.chunk, flag,
                                            graphs, stage))
            sent = loop.state

    @staticmethod
    def _rounds(loop: T.Loop, flag: torch.Tensor, m: int) -> None:
        state = loop.state
        for _ in range(m):
            state = loop.round_fn(state)
        for dst, src in zip(loop.state, state):
            dst.copy_(src)
        flag.copy_(T.pending(loop.state, loop.n))

    def __call__(self, *inputs):
        with trace.span("search"):
            for buf, x in zip(self.inputs, inputs):
                if x.shape != buf.shape or x.dtype != buf.dtype:
                    raise ValueError(f"compiled for {tuple(buf.shape)} "
                                     f"{buf.dtype}, called with "
                                     f"{tuple(x.shape)} {x.dtype}")
                buf.copy_(x)
            for step in self.steps:
                step.replay()
            return self.outputs
