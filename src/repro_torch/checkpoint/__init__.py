"""Fault-tolerant checkpointing of the port's training state."""
from repro_torch.checkpoint.store import (latest_step, restore_checkpoint,  # noqa: F401
                                          restore_latest, save_checkpoint)
