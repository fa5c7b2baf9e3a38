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

Launch counters: a kernel wrapper counts in Python, which a replay does not
run.  The launches made while a graph is captured are taken off the
counters again (a capture launches nothing), remembered per graph, and
added at every replay, so ``kernels.launch_counts()`` counts what ran on
the card either way.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from repro_torch import kernels
from repro_torch.core import traversal as T


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
        loop = next(gen)
        while True:
            if loop.max_rounds:
                loop.round_fn(loop.state)
            loop = gen.send(T.run_to_convergence(*loop))
    except StopIteration:
        pass


class EagerProgram:
    """A program run eagerly at every call (the CPU's compiled call)."""

    def __init__(self, program: Callable[..., T.Program]):
        self.program = program

    def __call__(self, *inputs):
        with torch.no_grad():
            return T.run_program(self.program(*inputs))


class _Segment:
    """A captured stretch of straight-line code."""

    def __init__(self, graph: torch.cuda.CUDAGraph, launches: Dict[str, int]):
        self.graph, self.launches = graph, launches

    def replay(self) -> None:
        self.graph.replay()
        kernels.add_launch_counts(self.launches)


class _CapturedLoop:
    """A captured convergence loop: ``graphs[m]`` runs m rounds in place on
    the loop's state and then sets ``flag`` to whether work is left."""

    def __init__(self, max_rounds: int, chunk: int, flag: torch.Tensor,
                 graphs: Dict[int, Tuple[torch.cuda.CUDAGraph, Dict[str, int]]]):
        self.max_rounds, self.chunk = max_rounds, chunk
        self.flag, self.graphs = flag, graphs
        self.tests = self.rounds = 0      # of the last replay

    def replay(self) -> None:
        self.tests = self.rounds = 0
        for m in T.chunk_sizes(self.max_rounds, self.chunk):
            self.tests += 1
            if not bool(self.flag):
                break
            graph, launches = self.graphs[m]
            graph.replay()
            kernels.add_launch_counts(launches)
            self.rounds += m


class GraphedProgram:
    """A program captured as CUDA graphs at the shapes of ``inputs``.

    Calling it copies the arguments into the static input buffers, replays
    the graphs and returns the static outputs, which the next call
    overwrites: read or copy them before calling again.  One memory pool
    holds every graph's tensors; the graphs replay in the order they were
    captured (a loop's chunks in place), so they may share it.

    ``syncs`` and ``rounds`` describe the last call: the host tests of
    convergence it made, and the rounds it ran in each loop (chunks
    included, so at most ``CHUNK − 1`` past the batch's slowest query)."""

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

    def _graph(self, side: torch.cuda.Stream, body: Callable):
        """Capture ``body()`` into a new graph: ``(graph, launches, body's
        result)``."""
        graph = torch.cuda.CUDAGraph()
        before = kernels.launch_counts()
        try:
            with warnings.catch_warnings():
                # a stretch that only takes views (a top-k slice) captures
                # no node; its empty graph replays as a no-op
                warnings.filterwarnings("ignore", "The CUDA Graph is empty")
                with torch.cuda.graph(graph, pool=self.pool, stream=side):
                    out = body()
        except RuntimeError as e:
            raise RuntimeError(f"CUDA graph capture of a search program "
                               f"failed: {e}") from e
        finally:
            after = kernels.launch_counts()
            launches = {k: after[k] - before[k] for k in after
                        if after[k] != before[k]}
            kernels.add_launch_counts({k: -v for k, v in launches.items()})
        return graph, launches, out

    def _capture(self, gen: T.Program, side: torch.cuda.Stream) -> None:
        sent = None
        while True:
            def segment(sent=sent):
                try:
                    loop = gen.send(sent)
                except StopIteration as done:
                    return None, done.value
                # the loop's own buffers (a state may hold one tensor in two
                # fields, which in-place rounds would tie together)
                state = T.SearchState(*(t.clone() for t in loop.state))
                return loop._replace(state=state), T.pending(state, loop.n)

            graph, launches, (loop, out) = self._graph(side, segment)
            self.steps.append(_Segment(graph, launches))
            if loop is None:
                self.outputs = out
                return
            flag = out
            graphs = {}
            for m in sorted(set(T.chunk_sizes(loop.max_rounds, self.chunk))):
                g, n_launch, _ = self._graph(
                    side, lambda m=m: self._rounds(loop, flag, m))
                graphs[m] = (g, n_launch)
            self.steps.append(_CapturedLoop(loop.max_rounds, self.chunk, flag,
                                            graphs))
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
        for buf, x in zip(self.inputs, inputs):
            if x.shape != buf.shape or x.dtype != buf.dtype:
                raise ValueError(f"compiled for {tuple(buf.shape)} "
                                 f"{buf.dtype}, called with "
                                 f"{tuple(x.shape)} {x.dtype}")
            buf.copy_(x)
        for step in self.steps:
            step.replay()
        return self.outputs

    @property
    def syncs(self) -> int:
        return sum(s.tests for s in self._loops())

    @property
    def rounds(self) -> List[int]:
        return [s.rounds for s in self._loops()]

    def _loops(self) -> List[_CapturedLoop]:
        return [s for s in self.steps if isinstance(s, _CapturedLoop)]
