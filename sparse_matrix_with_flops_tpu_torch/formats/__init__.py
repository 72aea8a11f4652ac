"""formats of the PyTorch port."""
