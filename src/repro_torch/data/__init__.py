from repro_torch.data.synthetic import BatchFn, SyntheticMNIST
from repro_torch.data.stream import (ChunkPrefetcher, StackedChunkSource,
                                     batch_bytes, split_chunks, stack_chunk)

__all__ = ["BatchFn", "SyntheticMNIST", "ChunkPrefetcher",
           "StackedChunkSource", "batch_bytes", "split_chunks",
           "stack_chunk"]
