"""utils package of the PyTorch port."""
