from . import loss
from .core import (
    State,
    build_optimizer,
    create_state,
    evaluate,
    example_batch,
    generator_args,
    load_checkpoint,
    save_checkpoint,
    steps_per_dispatch,
    train,
    train_step)
