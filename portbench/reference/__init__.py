"""The plain reference: the sampling contract, the models from their
published equations and Adam, in plain torch. Nothing here imports the
program or JAX."""
