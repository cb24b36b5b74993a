"""Spatial decomposition of the sorted tier into z-slabs.

Counterpart of the slab step of ``sphfluidsimulation_tpu/parallel``
(``slab_pallas.py`` with the parts of ``slab.py`` it uses). The JAX
package's scene batching (``batch.py``), row-sharded domain step
(``domain.py``) and sites slab step are ROADMAP.md queue A, items A9/A11.
The slab axis is a ring of shards (``ring.py``): ``LocalRing(d)`` runs d
shards in one process on one device, ``DistRing`` one shard a process over
``torch.distributed``.
"""

from .ring import DistRing, LocalRing  # noqa: F401
from .slab import SlabState, collect, distribute  # noqa: F401
from .slab_pallas import (  # noqa: F401
    PallasSlabSpec,
    make_pallas_slab_step,
    make_pallas_spec,
)
