"""Hand-written CUDA kernels of the PyTorch port, each beside its plain
PyTorch version (``ref.py``) and its dispatching wrapper (``ops.py``)."""
