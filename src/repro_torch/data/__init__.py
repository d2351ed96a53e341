from .synthetic import SPECS, Dataset, make_dataset, make_lm_dataset
from .partition import ClientData, staircase_partition
from .pipeline import device_batches, epoch_batches, sample_batch_indices

__all__ = ["SPECS", "Dataset", "make_dataset", "make_lm_dataset",
           "ClientData", "staircase_partition", "device_batches",
           "epoch_batches", "sample_batch_indices"]
