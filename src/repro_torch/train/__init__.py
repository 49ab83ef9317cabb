from .fit import federated_fit
from .local import evaluate

__all__ = ["evaluate", "federated_fit"]
