"""Multi-device parallelism: the (data, model) mesh and the slicing of
weights, caches and batches for it (mesh.py), ring attention for the
sequence-parallel prefill (ring.py), multi-process bring-up (multihost.py)
and failure detection and recovery for serving (elastic.py).  Port of
`kivi_tpu/parallel/` over `torch.distributed`: NCCL on CUDA, gloo on the
CPU.
"""

from kivi_tpu_torch.parallel.elastic import (
    ElasticBatcher,
    Heartbeat,
    StepWatchdog,
    surviving_mesh,
)
from kivi_tpu_torch.parallel.ring import ring_attention
from kivi_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    auto_mesh_shape,
    cache_pspecs,
    make_mesh,
    param_pspecs,
    shard_caches,
    shard_params,
    shard_tokens,
    token_pspec,
)

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "ElasticBatcher", "Heartbeat",
    "StepWatchdog", "auto_mesh_shape", "cache_pspecs", "make_mesh",
    "param_pspecs", "ring_attention", "shard_caches", "shard_params",
    "shard_tokens", "surviving_mesh", "token_pspec",
]
