"""Checkpoint bridge: the JAX package's path-keyed npz into port tensors."""
