from .federated_split import client_batch_stream, iid_client_split
from .synthetic import SyntheticClassification, make_teacher_dataset

__all__ = ["SyntheticClassification", "client_batch_stream",
           "iid_client_split", "make_teacher_dataset"]
