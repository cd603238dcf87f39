from repro_torch.checkpoint.checkpointer import (Checkpointer, latest_step,
                                                 read_manifest, restore, save)

__all__ = ["Checkpointer", "latest_step", "read_manifest", "restore", "save"]
