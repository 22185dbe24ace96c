"""The mesh of shards and its collectives, coded shards and the
multi-process ingest (port of ``predictionio_tpu/parallel/``)."""

from .coded import (
    ParityExhausted,
    ShardHealth,
    build_coded_gather,
    build_parity_fn,
)
from .collectives import (
    all_gather_blocks,
    all_reduce_sum,
    all_to_all_blocks,
    reduce_scatter_sum,
    ring_shift,
)
from .ingest import (
    find_columnar_sharded,
    gather_ratings,
    ids_exchange,
    read_ratings_distributed,
)
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    distributed_init,
    fence,
    make_mesh,
    pad_to_multiple,
    shard_put,
)

__all__ = [
    "ParityExhausted",
    "ShardHealth",
    "build_coded_gather",
    "build_parity_fn",
    "all_gather_blocks",
    "all_reduce_sum",
    "all_to_all_blocks",
    "reduce_scatter_sum",
    "ring_shift",
    "find_columnar_sharded",
    "gather_ratings",
    "ids_exchange",
    "read_ratings_distributed",
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "distributed_init",
    "fence",
    "make_mesh",
    "pad_to_multiple",
    "shard_put",
]
