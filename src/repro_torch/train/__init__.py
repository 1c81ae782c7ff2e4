"""Training of the port: the reference's AdamW and train step."""
from .optimizer import OptConfig, adamw_update, init_opt_state  # noqa: F401
from .step import make_loss_fn, make_train_step  # noqa: F401
