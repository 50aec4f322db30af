"""The serving benchmark of the PyTorch/CUDA port (``python servebench/run.py``)."""
