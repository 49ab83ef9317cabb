from .fit import federated_fit, sharded_client_fit, streamed_federated_fit
from .local import (LocalTrainConfig, evaluate, train_local_zampling,
                    train_step)
from .steps import (TrainState, init_train_state, make_train_step,
                    make_zampling_train_step)

__all__ = ["LocalTrainConfig", "TrainState", "evaluate", "federated_fit",
           "init_train_state", "make_train_step", "make_zampling_train_step",
           "sharded_client_fit", "streamed_federated_fit",
           "train_local_zampling", "train_step"]
