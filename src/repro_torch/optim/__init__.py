"""The AdamW optimizer of the PyTorch port (``adamw``)."""
