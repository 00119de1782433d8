"""evaluation: classifier metrics and the batched evaluation loop."""

from deeplearning4j_tpu_torch.evaluation.evaluation import (ConfusionMatrix,
                                                            Evaluation,
                                                            evaluate)
