"""train package of the PyTorch port."""
