"""The benchmark of ``dips_tpu_torch``, the PyTorch and CUDA port of
DiPs, on NVIDIA GPUs: ``python3 -m portbench --help``."""
