"""The benchmark of the PyTorch and CUDA port (`rgbd360_tpu_torch`).

`python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once on the CUDA device
and prints one JSON result line; see `harness.py`.
"""
