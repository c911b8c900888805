"""The benchmark of the PyTorch/CUDA port of TTrace (see run.py)."""
