"""models package of the PyTorch port."""
