"""The serving benchmark of the PyTorch/CUDA port (``repro_torch``).

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once on the card and prints one JSON
line. See ``bench/README.md``.
"""
