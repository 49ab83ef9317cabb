"""The server's upload validation: popcount checksums on the wire.

The JAX package's ``fault/validate.py``.  An upload of tensor ``path``
is uint32 mask lanes (packed transports) or an f32 mask, so its total
popcount is an exact small integer either way (continuous-mode
probabilities take the same f32 sum at both ends).  The client
declares that count in a small header, and the server recounts the
received payload: a damaged upload fails the compare, and a count above
``spec.n`` the bound.  A failed upload is left out of the weighted
aggregate.  Leading client axes are kept: (K,) verdicts for a stacked
round, a 0-d one for a rank's upload.
"""

from __future__ import annotations

import torch

from ..comm.bitpack import packed_total_popcount


def upload_counts(z_all, zspecs, packed: bool):
    """{path: checksum} of the uploads, leading axes kept: int64 popcounts
    of lanes, else f32 sums."""
    return {path: (packed_total_popcount(z_all[path]) if packed
                   else z_all[path].sum(-1))
            for path in zspecs.specs}


def validate_uploads(z_all, declared, zspecs, packed: bool,
                     total=None) -> torch.Tensor:
    """True where every tensor of a client's received upload has its
    declared checksum and no more than ``spec.n`` set bits.  On a model
    rank (``z_all`` its slices) ``total(path, x)`` sums a slice's
    checksum over the whole upload, as ``declared`` is."""
    received = upload_counts(z_all, zspecs, packed)
    valid = None
    for path, spec in zspecs.specs.items():
        c = received[path] if total is None else total(path, received[path])
        ok = (c == declared[path]) & (c <= spec.n)
        valid = ok if valid is None else valid & ok
    return valid
