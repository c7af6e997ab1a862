"""The benchmark of `parq_torch` on one NVIDIA H100, driven by data: see
benchmark/run.py and PERF.md. Importing it loads nothing."""
