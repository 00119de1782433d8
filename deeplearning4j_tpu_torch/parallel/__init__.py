"""Distributed runtime: data-parallel training over `torch.distributed`
and checkpoints.

Counterpart of `deeplearning4j_tpu/parallel/`. The data plane (gradients,
parameters) is collectives over a process group inside each rank's train
step; the control plane (membership, heartbeats, job routing, status
REST) is the host-side coordinator.

Modules:
  mesh            process groups as meshes (the dp axis), batch sharding
  averaging       parameter averaging / aggregation
  data_parallel   the sync, masked, grad-accum, averaging and ZeRO-1 steps
                  and `DataParallelTrainer`
  coordinator     host-side state tracker: workers, heartbeats, jobs, REST
  config_registry configs parked for workers, on disk or over HTTP
  checkpoint      params, updater state and data cursor, both layouts

Tensor, sequence, pipeline and expert parallelism (`plan.py`,
`sequence.py`, `pipeline.py`, `expert.py`) are ROADMAP.md queue A item
10b.
"""

from deeplearning4j_tpu_torch.parallel.averaging import (ParameterAggregator,
                                                         average_pytrees,
                                                         merge)
from deeplearning4j_tpu_torch.parallel.checkpoint import CheckpointFormatError
from deeplearning4j_tpu_torch.parallel.data_parallel import (
    DataParallelTrainer, make_dp_train_step, make_zero1_train_step,
    zero1_shard_state)
from deeplearning4j_tpu_torch.parallel.mesh import make_mesh, mesh_axes

__all__ = ["CheckpointFormatError", "DataParallelTrainer",
           "ParameterAggregator", "average_pytrees", "make_dp_train_step",
           "make_mesh", "make_zero1_train_step", "merge", "mesh_axes",
           "zero1_shard_state"]
