"""Multi-device execution of the port: data, tensor, fully sharded and
pipeline parallelism, ring attention and the multi-process launch (port of
``manipose_tpu/parallel``; one process a device over ``torch.distributed``)."""

from .ring_attention import RingSpec, ring_attention
from .pipeline import pipeline_apply, stack_stage_params
from .multihost import (
    barrier,
    global_batch,
    is_primary,
    make_hybrid_mesh,
)
from .multihost import initialize as initialize_multihost
from .mesh import (
    fsdp_param_spec,
    make_mesh,
    param_spec,
    replicate,
    shard_batch,
    shard_params,
)

__all__ = [
    "barrier",
    "fsdp_param_spec",
    "global_batch",
    "initialize_multihost",
    "is_primary",
    "make_hybrid_mesh",
    "make_mesh",
    "param_spec",
    "pipeline_apply",
    "replicate",
    "shard_batch",
    "shard_params",
    "stack_stage_params",
    "RingSpec",
    "ring_attention",
]
