"""Data generators of the PyTorch port (see ``repro.data``)."""
