"""Front ends of the PyTorch port (``serve_search``)."""
