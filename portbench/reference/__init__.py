"""Plain PyTorch reference of the VAE-GP-ODE model that the benchmark
holds the port to. It imports torch and numpy alone: nothing of the
port, of the JAX package or of JAX."""
