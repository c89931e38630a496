"""gpubench: the benchmark of wah_tpu_torch, the PyTorch and CUDA port of
WAH bitmap compression, on an NVIDIA H100.

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json (at the repository's root) once and prints
one JSON result line. It drives wah_tpu_torch only; nothing here imports
JAX, wah_tpu, benchmarks/ or bench.py (gpubench/tests holds the check).
"""
