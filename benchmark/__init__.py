"""The benchmark of simxns_tpu_torch: run one cell with ``python3 benchmark/run.py``."""
