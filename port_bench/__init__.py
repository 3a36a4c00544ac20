"""Benchmark of the PyTorch/CUDA port (``human_instance_segmentation_tpu_torch``).

``python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once on the CUDA device and prints one
JSON line. Cells, configurations, traffic mixes, limits and metrics are
files found by the names in ``BENCHMARK.json``; see ``lib/spec.py``.
"""
