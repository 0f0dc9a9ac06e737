"""The benchmark of the PyTorch/CUDA port: ``python portbench/run.py``."""
