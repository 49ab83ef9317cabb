"""The paper's own architectures (MNIST feedforward, §3).

SMALL: 784-20-20-10 (§3.1, §3.3); MNISTFC: 784-300-100-10 = 266,610
parameters (§3.2, App. B.1), the width the paper trains the federated
round at.
"""

from ..models.mlp import MNISTFC_DIMS, SMALL_DIMS, param_count

SMALL = SMALL_DIMS
MNISTFC = MNISTFC_DIMS

if param_count(MNISTFC) != 266_610:  # the paper's figure, §3.2
    raise AssertionError("MNISTFC parameter count drifted from the paper's")
