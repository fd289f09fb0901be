"""Parallelism over torch.distributed: the mesh and its rules (mesh.py),
collectives (comm.py), tensor parallelism for serving and training
(tp.py, behind TextInferenceInterface(mesh=, shard_rules=) and
LMTrainer(mesh=, rules=)), sequence parallelism for training (sp.py),
ring attention, expert and pipeline parallelism, and the composed
dp x pp x tp trainer (pipeline_trainer.py). The port's counterpart of
whisper_tensor_tpu/parallel/."""

from .comm import (all_gather, all_reduce, all_reduce_many, broadcast,
                   copy_in, gather_out, reduce_out, reduce_scatter,
                   ring_shift)
from .mesh import (GPT2_RULES, LLAMA_RULES, Mesh, Sharding, auto_mesh,
                   data_sharding, distributed_init, fsdp_shardings,
                   gather_block, local_block, make_mesh, multihost_mesh,
                   named, shard_array, weight_shardings)
from .pipeline import pipeline_apply
from .pipeline_trainer import LayeredLM, PipelinedLMTrainer, layered_gpt2
from .sp import shard_sequence
from .tp import shard_graph

__all__ = [
    "GPT2_RULES", "LLAMA_RULES", "LayeredLM", "Mesh", "PipelinedLMTrainer",
    "Sharding", "all_gather", "all_reduce", "all_reduce_many", "auto_mesh",
    "broadcast", "copy_in", "data_sharding", "distributed_init",
    "fsdp_shardings", "gather_block", "gather_out", "layered_gpt2",
    "local_block", "make_mesh", "multihost_mesh", "named", "pipeline_apply",
    "reduce_out", "reduce_scatter", "ring_shift", "shard_array",
    "shard_graph", "shard_sequence", "weight_shardings",
]
