"""Parallelism: scene batching, the row-sharded domain step and the slab
decomposition.

Counterpart of ``sphfluidsimulation_tpu/parallel``: ``batch.py`` (scenes in
lockstep, BASELINE config 5), ``domain.py`` (row shards with all-gather
neighbours), ``slab.py`` (the sites tier's slab step, the row buffers and
the migration ring) and ``slab_pallas.py`` (the sorted tier's slab step).
The slab and shard axis is a ring (``ring.py``): ``LocalRing(d)`` runs d
shards in one process on one device, ``DistRing`` one shard a process over
``torch.distributed``.
"""

from .batch import BatchedScenes, batch_configs, make_batched_step  # noqa: F401
from .domain import (  # noqa: F401
    make_batched_sharded_step,
    make_sharded_frame_step,
    shard_state,
)
from .ring import DistRing, LocalRing  # noqa: F401
from .slab import (  # noqa: F401
    SlabState,
    collect,
    distribute,
    make_batched_slab_step,
    make_slab_rollout,
    make_slab_step,
)
from .slab_pallas import (  # noqa: F401
    PallasSlabSpec,
    make_pallas_slab_step,
    make_pallas_spec,
)
