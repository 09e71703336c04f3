"""Atomic checkpoints: one ``.npy`` of raw bytes per leaf and a JSON
manifest, in the reference's on-disk format."""
from repro_torch.checkpoint.checkpointer import (  # noqa: F401
    ShapeDtype, available_steps, latest_step, read_manifest,
    restore_checkpoint, save_checkpoint)
