"""kernels package of the PyTorch port."""
