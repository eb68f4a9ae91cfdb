"""The benchmark of thunder_tpu_torch: run ``python asrbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""
