"""The benchmark of the PyTorch and CUDA port: a frame stream per cell,
driven by the data files beside this package (see ``run.py``)."""
