"""analysis layer of the PyTorch port: the plan audit."""
