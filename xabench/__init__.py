"""The benchmark of the PyTorch and CUDA port of the XA codec."""
