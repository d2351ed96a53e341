"""The PyTorch and CUDA port's benchmark: data-driven cells, one run each
(``python gpubench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>``).  See ``gpubench/README.md``."""
