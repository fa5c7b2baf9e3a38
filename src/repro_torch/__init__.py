"""PilotANN on PyTorch and CUDA (NVIDIA H100): a port of the JAX/TPU
package ``repro``, which stays the reference.

This package imports ``torch`` and ``numpy`` only — nothing of JAX and
nothing of ``repro``.  Its slices so far: the multistage search path
(``core.engine.PilotANNIndex.search``), the device graph build, the
quantized pilot payloads, and the RAG serving path (``serving.
RagPipeline`` over the dense LM of ``models``), with hand-written CUDA
kernels (``kernels/``, ``csrc/``) for every Pallas kernel of the
reference: the pilot traversal, the FES distances, the NN-descent merge,
the expand-merge and flash attention.
"""
