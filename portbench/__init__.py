"""The benchmark of `promonet_tpu_torch` on an NVIDIA H100

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once and prints one
JSON line. See `run.py`.
"""
