"""Device kernels and tensor ops of the port."""
