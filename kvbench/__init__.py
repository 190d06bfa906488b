"""The benchmark of the PyTorch/CUDA port (kivi_tpu_torch): see run.py."""
