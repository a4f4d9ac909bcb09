"""The benchmark of cusift_tpu_torch: `python3 -m benchmark.run` runs one
cell of BENCHMARK.json (see `run.py`)."""
