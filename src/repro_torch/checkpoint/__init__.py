from repro_torch.checkpoint.ckpt import (CheckpointCorruptError, CheckpointManager,
                                         all_steps, latest_step,
                                         restore_checkpoint, save_checkpoint)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "all_steps", "CheckpointManager", "CheckpointCorruptError"]
