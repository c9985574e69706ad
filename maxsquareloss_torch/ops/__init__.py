"""ops package of the PyTorch port."""
