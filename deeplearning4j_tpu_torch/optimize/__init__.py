"""Training: the updater chain, the solver and iteration listeners, and
the captured step and serve caches.

The package exports the JAX package's `optimize` names: `Solver` and
`optimize` (`solver.py`), `UpdaterState`, `init_updater` and
`adjust_gradient` (`updater.py`), `TrainStepCache` and `InferCache`.
"""

from deeplearning4j_tpu_torch.optimize.solver import Solver, optimize
from deeplearning4j_tpu_torch.optimize.updater import (UpdaterState,
                                                       adjust_gradient,
                                                       init_updater)
from deeplearning4j_tpu_torch.optimize.step_cache import TrainStepCache
from deeplearning4j_tpu_torch.optimize.infer_cache import InferCache
