"""Serving on the port: the batching queue, the throughput engine with its
mutation queues and resilience (ROADMAP Queue A item 4), the semantic cache
(item 3) and the RAG pipeline."""

from repro_torch.serving.batching import (TERMINAL_STATES, BatchingQueue,
                                          Request)
from repro_torch.serving.rag import RagPipeline
from repro_torch.serving.semantic_cache import SemanticCache
from repro_torch.serving.server import (MutationTicket, ServeParams,
                                        ThroughputEngine)

__all__ = ["BatchingQueue", "MutationTicket", "RagPipeline", "Request",
           "SemanticCache", "ServeParams", "TERMINAL_STATES",
           "ThroughputEngine"]
