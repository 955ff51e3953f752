"""Plain PyTorch references of the port's models (fp32, no kernels), for the tests."""
