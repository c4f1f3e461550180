"""Baselines of the PyTorch port: exact search as the recall ground truth."""
