from repro_torch.data.synthetic import (BatchFn, SyntheticMNIST,
                                        synthetic_token_batch)
from repro_torch.data.stream import (ChunkPrefetcher, StackedChunkSource,
                                     batch_bytes, split_chunks, stack_chunk)

__all__ = ["BatchFn", "SyntheticMNIST", "synthetic_token_batch",
           "ChunkPrefetcher", "StackedChunkSource", "batch_bytes",
           "split_chunks", "stack_chunk"]
