"""Serving: the micro-batching gateway, the continuous generation batcher
and their HTTP front."""

from deeplearning4j_tpu_torch.serving.batcher import (ContinuousBatcher,
                                                      GenerationStream,
                                                      MicroBatcher,
                                                      ServerOverloaded)
from deeplearning4j_tpu_torch.serving.server import ModelServer, ServerDraining

__all__ = ["ContinuousBatcher", "GenerationStream", "MicroBatcher",
           "ModelServer", "ServerDraining", "ServerOverloaded"]
