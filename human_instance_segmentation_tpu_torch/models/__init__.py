"""Models of the PyTorch port (NCHW inside, NHWC at the assembly's edge)."""
