"""The harness of the port's benchmark: manifest, traffic, drivers, readers.

Nothing here imports the JAX package; the drivers import the PyTorch
port (``repro_torch``) only inside the functions that run it.
"""
