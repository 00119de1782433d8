"""Distributed runtime: data-parallel training over `torch.distributed`
and checkpoints.

Counterpart of `deeplearning4j_tpu/parallel/`. The data plane (gradients,
parameters) is collectives over a process group inside each rank's train
step; the control plane (membership, heartbeats, job routing, status
REST) is the host-side coordinator.

Modules:
  mesh            process groups as meshes (named axes, a sub-group an
                  axis), batch sharding
  plan            `ShardPlan`, `parse_mesh_spec`, `plan_mesh`: the
                  (batch, model) layout and its keys and per-leaf specs
  tensor          the model axis: Megatron collectives as autograd
                  Functions, the split layout, `TensorParallel`, and the
                  serving side (`ServeParallel`, `shard_params`)
  followers       rank 0's calls to the other ranks of a serving mesh
  averaging       parameter averaging / aggregation
  data_parallel   the sync, masked, grad-accum, averaging, ZeRO-1 and
                  plan (tensor-parallel) steps and `DataParallelTrainer`
  sequence        ring and Ulysses attention over a sequence axis
  pipeline        GPipe microbatch pipelining over a stage axis
  expert          Switch mixture-of-experts over an expert axis
  coordinator     host-side state tracker: workers, heartbeats, jobs, REST
  config_registry configs parked for workers, on disk or over HTTP
  checkpoint      params, updater state and data cursor, both layouts

Serving under a mesh (`MultiLayerNetwork.set_serve_mesh`, `serve
--mesh`, `generate --mesh`) runs through `optimize/infer_cache.py` on
`serve_mesh` or `plan_mesh`.
"""

from deeplearning4j_tpu_torch.parallel.averaging import (ParameterAggregator,
                                                         average_pytrees,
                                                         merge)
from deeplearning4j_tpu_torch.parallel.checkpoint import CheckpointFormatError
from deeplearning4j_tpu_torch.parallel.data_parallel import (
    DataParallelTrainer, make_dp_train_step, make_plan_train_step,
    make_zero1_train_step, plan_shard_state, zero1_shard_state)
from deeplearning4j_tpu_torch.parallel.mesh import make_mesh, mesh_axes
from deeplearning4j_tpu_torch.parallel.plan import (ShardPlan,
                                                    parse_mesh_spec,
                                                    plan_mesh)

__all__ = ["CheckpointFormatError", "DataParallelTrainer",
           "ParameterAggregator", "ShardPlan", "average_pytrees",
           "make_dp_train_step", "make_mesh", "make_plan_train_step",
           "make_zero1_train_step", "merge", "mesh_axes", "parse_mesh_spec",
           "plan_mesh", "plan_shard_state", "zero1_shard_state"]
