"""The parameter tree's partition rules and the sharded bank layout on one
card (counterpart of ``repro.sharding``): ``partitioning`` holds the
reference's per-leaf rule table and the layout's data extent, ``flatten``
the bank transforms. The mesh machinery (shardings, ``shard_map``, the
collectives) has no meaning on one card and is not ported."""

from repro_torch.sharding.flatten import (UNIT, ShardedFlatSpec,
                                          bank_to_param_tree,
                                          flatten_to_bank,
                                          make_sharded_flat_spec, ravel_into)
from repro_torch.sharding.partitioning import (n_workers, param_spec,
                                               param_specs)

__all__ = ["UNIT", "ShardedFlatSpec", "bank_to_param_tree",
           "flatten_to_bank", "make_sharded_flat_spec", "n_workers",
           "param_spec", "param_specs", "ravel_into"]
