from .paper import (comm_savings_table, run_downlink_tradeoff,
                    run_federated, run_heterogeneity, run_integrality,
                    run_local_compression, run_sensitivity, run_wire_formats,
                    run_zhou_comparison)

__all__ = [
    "comm_savings_table", "run_downlink_tradeoff", "run_federated",
    "run_heterogeneity", "run_integrality", "run_local_compression",
    "run_sensitivity", "run_wire_formats", "run_zhou_comparison",
]
