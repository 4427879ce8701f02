"""The benchmark of the PyTorch and CUDA port (``repro_torch``): federated
LM rounds on one card, driven by the data files beside this module.  Run
it as ``python3 portbench/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`` from the root of a checkout (README.md)."""
