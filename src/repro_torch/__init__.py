"""PilotANN on PyTorch and CUDA (NVIDIA H100): a port of the JAX/TPU
package ``repro``, which stays the reference.

This package imports ``torch`` and ``numpy`` only — nothing of JAX and
nothing of ``repro``.  Its slice so far is the multistage search path
(``core.engine.PilotANNIndex.search``) with hand-written CUDA kernels for
the stage-① pilot traversal and the FES distances (``kernels/``,
``csrc/``).
"""
