"""Hand-written Hopper kernels (sources in `repro_torch/csrc/`), their plain
PyTorch versions (`ref.py`), and the CPU/CUDA dispatch (`ops.py`)."""
