"""The benchmark of the PyTorch/CUDA port (`smplifyx_torch`): BENCHMARK.json
at the repository root names its cells, and `run.py` runs one."""
