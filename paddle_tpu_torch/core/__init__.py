"""Type system and operator registry of the PyTorch port."""
