"""Synthetic training data of the PyTorch port (``pipeline``)."""
