"""The benchmark of the PyTorch and CUDA port (``cloudsc2_tpu_torch``):
``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``.
See ``portbench/README.md``."""
