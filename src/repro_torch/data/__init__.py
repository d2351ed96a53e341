from .synthetic import SPECS, Dataset, make_dataset
from .partition import ClientData, staircase_partition
from .pipeline import sample_batch_indices

__all__ = ["SPECS", "Dataset", "make_dataset", "ClientData",
           "staircase_partition", "sample_batch_indices"]
