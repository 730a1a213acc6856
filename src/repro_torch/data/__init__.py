"""repro_torch.data — deterministic synthetic pipeline + RMQ-based sequence packing."""

from . import packing, pipeline
from .packing import pack_documents
from .pipeline import batch_iterator, synthetic_batch

__all__ = ["packing", "pipeline", "pack_documents", "batch_iterator", "synthetic_batch"]
