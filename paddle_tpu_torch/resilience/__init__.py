"""Fault-tolerance helpers of the PyTorch port."""
