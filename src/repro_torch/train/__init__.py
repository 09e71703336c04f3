"""Train steps and the trainer loop (``train.train_loop``), counterpart of
``repro.train``; ``make_state_shardings`` is ROADMAP A.13.3."""
from repro_torch.train.train_loop import (  # noqa: F401
    make_train_step, make_compressed_train_step, TrainState, Trainer)
