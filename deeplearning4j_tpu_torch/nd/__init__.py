"""Tensor-level ops, attention math and the CUDA kernels.

The package exports the JAX package's `nd` names: the activation registry
(`ops.py`), the losses (`losses.py`) and the samplers (`random.py`, as
`ndrandom`). Importing it builds no kernel and starts no CUDA context.
"""

from deeplearning4j_tpu_torch.nd.ops import (
    Activation,
    activate,
    activation_derivative,
    get_activation,
    register_activation,
)
from deeplearning4j_tpu_torch.nd.losses import (LossFunction,
                                                 score as loss_score)
from deeplearning4j_tpu_torch.nd import random as ndrandom
