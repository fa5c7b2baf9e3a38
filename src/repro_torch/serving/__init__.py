"""Serving on the port: the RAG pipeline (the throughput engine and the
semantic cache wait for ROADMAP Queue A items 6 and 7)."""

from repro_torch.serving.rag import RagPipeline

__all__ = ["RagPipeline"]
