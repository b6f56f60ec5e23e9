"""Synthetic training data of the PyTorch port (``pipeline``) and each
rank's rows of it under a device mesh (``sharded``)."""
