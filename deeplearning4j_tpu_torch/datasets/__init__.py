"""datasets: the DataSet container and the batch iterators."""

from deeplearning4j_tpu_torch.datasets.dataset import (DataSet,
                                                       labels_to_one_hot)
from deeplearning4j_tpu_torch.datasets.iterator import (
    DataSetIterator, DeviceBatch, ListDataSetIterator,
    MovingWindowBaseDataSetIterator, MultipleEpochsIterator,
    PrefetchIterator, ReconstructionDataSetIterator, SamplingDataSetIterator,
    TestDataSetIterator, moving_window_dataset)
