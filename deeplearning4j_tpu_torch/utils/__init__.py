"""Shared utilities: the port's copies of the JAX package's `utils/`
modules ported so far (the disk-backed queue) and the device Viterbi
decoder."""

from deeplearning4j_tpu_torch.utils.disk_queue import DiskBasedQueue
from deeplearning4j_tpu_torch.utils.viterbi import Viterbi

__all__ = ["DiskBasedQueue", "Viterbi"]
