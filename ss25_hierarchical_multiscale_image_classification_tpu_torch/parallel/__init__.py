"""Data parallelism over a process group, and device layouts for the fleet.

Counterpart of the JAX package's ``parallel/``. JAX shards the batch over a
mesh inside one process; here one process runs per card (``torchrun``), each
loads its rows of every global batch (``feed.py``), and the collectives of
``collectives.py`` give the global BatchNorm statistics, the gathered NT-Xent
columns and the summed gradients. ``mesh.py`` joins the process group and
keeps the JAX mesh's shape rules for ranks and for the fleet's devices.

``make_mesh``, ``shard_batch`` and ``replicate`` resolve here at first use;
they stand for the JAX package's ``make_mesh``, ``shard_batch``,
``batch_sharding`` and ``replicated_sharding``, which describe the TPU mesh.
"""

from ss25_hierarchical_multiscale_image_classification_tpu_torch._exports import (
    lazy_exports,
)

__getattr__, __dir__ = lazy_exports(__name__, {
    "make_mesh": "mesh",
    "shard_batch": "mesh",
    "replicate": "mesh",
})
