"""Checkpoints in the reference's layout (``manifest.json`` plus one
``.npy`` per leaf): the weight bridge from the JAX reference (its
parameter tree, its on-disk checkpoints) and the training driver's
save / restore."""
from .bridge import params_from_jax, params_to_numpy  # noqa: F401
from .ckpt import (latest_step, restore_checkpoint,  # noqa: F401
                   save_checkpoint)
from .reader import load_reference_checkpoint  # noqa: F401
