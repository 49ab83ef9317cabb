from .optimizers import (AdamState, Optimizer, adam, apply_updates, chain,
                         clip_by_global_norm, sgd)

__all__ = ["AdamState", "Optimizer", "adam", "apply_updates", "chain",
           "clip_by_global_norm", "sgd"]
