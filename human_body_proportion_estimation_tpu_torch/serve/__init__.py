"""serve of the PyTorch port: the HTTP edge and its batchers."""
