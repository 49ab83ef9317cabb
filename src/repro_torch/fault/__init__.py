"""Partial participation: the JAX package's ``repro.fault``.

- ``population``: ``ClientPopulation``, N clients with sample counts,
  and the round's K-of-N cohort drawn at ``COHORT_CTR``;
- ``plan``: ``FaultPlan``, drop / straggler / corrupt / duplicate faults
  drawn per (round, client) at ``FAULT_CTR``, and the lane corruption
  drawn at ``CORRUPT_CTR``;
- ``validate``: the server's popcount checksums of the uploads.

Every draw is a hash of integers, so a scenario gives the JAX
package's codes, cohorts and lanes bit for bit.
"""

from .plan import (CORRUPT, CORRUPT_CTR, DROP, DUPLICATE, FAULT_CTR,
                   FAULT_NAMES, OK, STRAGGLER, FaultPlan, corrupt_uploads,
                   draw_faults)
from .population import COHORT_CTR, ClientPopulation
from .validate import upload_counts, validate_uploads

__all__ = [
    "ClientPopulation", "COHORT_CTR",
    "FaultPlan", "FAULT_CTR", "CORRUPT_CTR", "FAULT_NAMES",
    "OK", "DROP", "STRAGGLER", "CORRUPT", "DUPLICATE",
    "draw_faults", "corrupt_uploads",
    "upload_counts", "validate_uploads",
]
