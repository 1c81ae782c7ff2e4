"""Weight bridge from the JAX reference: its parameter tree (nested
dicts of numpy arrays) and its on-disk checkpoint layout."""
from .bridge import params_from_jax, params_to_numpy  # noqa: F401
from .reader import load_reference_checkpoint  # noqa: F401
