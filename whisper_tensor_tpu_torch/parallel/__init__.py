"""Parallelism over torch.distributed: the mesh and its rules (mesh.py),
collectives (comm.py), tensor- and data-parallel serving (tp.py, behind
TextInferenceInterface(mesh=, shard_rules=)), ring attention, expert
and pipeline parallelism. The port's counterpart of
whisper_tensor_tpu/parallel/, less pipeline_trainer.py."""
