from .fit import federated_fit, sharded_client_fit
from .local import (LocalTrainConfig, evaluate, train_local_zampling,
                    train_step)

__all__ = ["LocalTrainConfig", "evaluate", "federated_fit",
           "sharded_client_fit", "train_local_zampling", "train_step"]
