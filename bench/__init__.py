"""The benchmark of the PyTorch and CUDA port (`repro_torch`): see
README.md. Entry point: `python3 bench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`."""
