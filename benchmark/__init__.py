"""The benchmark of the PyTorch and CUDA port (``rvt_tpu_torch``): see ``run.py``."""
