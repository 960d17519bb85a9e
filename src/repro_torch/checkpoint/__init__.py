from repro_torch.checkpoint.ckpt import (AsyncCheckpointer,
                                         restore_checkpoint, save_checkpoint)

__all__ = ["AsyncCheckpointer", "restore_checkpoint", "save_checkpoint"]
