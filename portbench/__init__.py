"""The benchmark of the PyTorch port (`tritonk8ssupervisor_tpu_torch`).

`python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` once on the card and prints one JSON line.
See `portbench/README.md`.
"""
