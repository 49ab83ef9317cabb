"""Zampling core: the JAX package's ``repro.core``, in torch.

The federated entry points are exported lazily: ``comm`` imports
``core``'s modules, and ``core.federated`` imports ``comm``.
"""

__all__ = ["FederatedConfig", "decode_state", "encode_state",
           "federated_round", "local_update", "mask_program",
           "sharded_client_update"]


def __getattr__(name):
    if name in __all__:
        from . import federated

        return getattr(federated, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
