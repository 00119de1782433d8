"""Serving: the micro-batching gateway, the continuous generation batcher,
their HTTP front, and the fleet over it: `Router` spreads `/v1/predict`
over N replica processes sharing one store (hedged requests under a shared
`RetryBudget`), `FleetSupervisor` reaps and respawns them, `Autoscaler`
grows and shrinks the fleet, `ReplicaAgent` owns a host's replicas for a
remote supervisor, `CacheServer`/`CacheFetcher` carry store entries (the
tuned table among them) to a cold host, and `serving.metrics` renders the
fleet's counters as Prometheus text at `/metrics`. The JAX package's
names."""

from deeplearning4j_tpu_torch.reliability import (CircuitBreaker,
                                                  DeadlineExceeded,
                                                  RetryBudget)
from deeplearning4j_tpu_torch.serving.agent import (AgentClient,
                                                    RemoteReplicaHandle,
                                                    ReplicaAgent)
from deeplearning4j_tpu_torch.serving.autoscaler import Autoscaler
from deeplearning4j_tpu_torch.serving.batcher import (LATENCY_BUCKETS_S,
                                                      PRIORITIES,
                                                      ContinuousBatcher,
                                                      GenerationStream,
                                                      MicroBatcher,
                                                      ServerOverloaded)
from deeplearning4j_tpu_torch.serving.cachesync import (CacheFetcher,
                                                        CacheServer)
from deeplearning4j_tpu_torch.serving.metrics import (CONTENT_TYPE,
                                                      parse_prometheus_text,
                                                      replica_metrics,
                                                      router_metrics)
from deeplearning4j_tpu_torch.serving.router import Replica, Router
from deeplearning4j_tpu_torch.serving.server import ModelServer, ServerDraining
from deeplearning4j_tpu_torch.serving.supervisor import FleetSupervisor

__all__ = ["AgentClient", "Autoscaler", "CONTENT_TYPE", "CacheFetcher",
           "CacheServer", "CircuitBreaker", "ContinuousBatcher",
           "DeadlineExceeded", "FleetSupervisor", "GenerationStream",
           "LATENCY_BUCKETS_S", "MicroBatcher", "ModelServer", "PRIORITIES",
           "Replica", "RemoteReplicaHandle", "ReplicaAgent", "RetryBudget",
           "Router", "ServerDraining", "ServerOverloaded",
           "parse_prometheus_text", "replica_metrics", "router_metrics"]
