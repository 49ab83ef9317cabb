from .ckpt import (DOWNLINK_KEY, checkpoint_downlink, load_checkpoint,
                   save_checkpoint)

__all__ = ["save_checkpoint", "load_checkpoint", "checkpoint_downlink",
           "DOWNLINK_KEY"]
