"""The PyTorch + CUDA port's benchmark (see BENCHMARK.json and portbench/run.py)."""
