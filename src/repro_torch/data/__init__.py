from .federated_split import (client_batch_stream, cohort_batch_stream,
                              dirichlet_client_split, iid_client_split)
from .synthetic import (SyntheticClassification, lm_token_batches,
                        make_teacher_dataset)

__all__ = ["SyntheticClassification", "client_batch_stream",
           "cohort_batch_stream", "dirichlet_client_split",
           "iid_client_split", "lm_token_batches", "make_teacher_dataset"]
