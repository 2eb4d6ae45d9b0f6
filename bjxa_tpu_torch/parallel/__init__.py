"""Many-file and multi-device engines: the batched, restartable corpus
converter, and the scaling layer.

Port of :mod:`bjxa_tpu.parallel`.  Corpora shard over a device mesh (data
parallel over files), and a single huge stream shards its block range over
devices with only the two-int16-per-channel predictor state crossing shard
boundaries (sequence parallel), handed from device to device and iterated
to an exact fixed point.  One process drives its mesh
(:mod:`bjxa_tpu_torch.parallel.mesh`); multi-process corpus jobs wire up
through :mod:`bjxa_tpu_torch.parallel.distributed`.
"""

from bjxa_tpu_torch.parallel import distributed
from bjxa_tpu_torch.parallel.mesh import make_mesh, dp_sharding
from bjxa_tpu_torch.parallel.sharded import (
    decode_file_sharded,
    decode_corpus_sharded,
)

__all__ = [
    "distributed",
    "make_mesh",
    "dp_sharding",
    "decode_file_sharded",
    "decode_corpus_sharded",
]
