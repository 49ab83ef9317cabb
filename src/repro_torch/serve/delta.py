"""Round-to-round serving updates as XOR deltas of the score broadcast
(the JAX package's ``serve/delta.py``).

Between rounds t and t+1 most encoded words do not change (the
quantized codecs snap small moves to the same word when the server
keeps one dither word).  The delta is the XOR of the two rounds' word
bit patterns (f32 scores bitcast), zero where unchanged;
``apply_delta`` XORs it back into a live server's words, which gives
round t+1's words exactly.  torch has no uint32 bit operations on the
CPU, so the XOR runs on a signed view of the same width (int32 for f32
scores and uint32 lanes, int16 for u16 words); a patch is returned in
the words' unsigned dtype.

Cache survival: a tile's weights depend on the words only through the
drawn mask bits, so the exact invalidation set of a delta is the tiles
whose window holds a coordinate whose drawn bit flips
(``delta_flipped_windows``, with the serve kernels' draw expressions).
``apply_delta(..., cache=)`` drops exactly those, or every tile when
the draw word changes.

``delta_report`` counts the bytes of the delta against a full
broadcast (``comm.metering.delta_wire_bytes``).  It refuses the packed
codecs: the JAX package's raises there (it draws per coordinate from
the lanes and counts 0 bytes a word), so there is no reference to hold
a port of it to.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from ..comm.downlink import get_codec
from ..comm.metering import delta_wire_bytes, score_downlink_bytes
from ..core.sampling import as_word
from ..kernels import ops
from .state import ServeState

# a word dtype's XOR view (same width) and its patch dtype
_VIEW = {torch.float32: torch.int32, torch.uint32: torch.int32,
         torch.int32: torch.int32, torch.uint16: torch.int16,
         torch.uint8: torch.uint8}
_PATCH = {torch.float32: torch.uint32, torch.uint32: torch.uint32,
          torch.int32: torch.uint32, torch.uint16: torch.uint16,
          torch.uint8: torch.uint8}


def _bits(a: torch.Tensor) -> torch.Tensor:
    """A word array's bit pattern as a same-width XOR-able view."""
    if a.dtype not in _VIEW:
        raise ValueError(f"no word delta for dtype {a.dtype}")
    return a.view(_VIEW[a.dtype])


def word_delta(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """XOR patch old -> new of one word array (unsigned, zero where the
    word is unchanged)."""
    if old.shape != new.shape or old.dtype != new.dtype:
        raise ValueError(f"words differ in shape or dtype: "
                         f"{tuple(old.shape)} {old.dtype} vs "
                         f"{tuple(new.shape)} {new.dtype}")
    return (_bits(old) ^ _bits(new)).view(_PATCH[old.dtype])


def apply_word_delta(base: torch.Tensor, patch: torch.Tensor) -> torch.Tensor:
    """XOR a patch into a word array, keeping the word dtype."""
    return (_bits(base) ^ _bits(patch.to(base.device))).view(base.dtype)


def changed_words(patch: torch.Tensor) -> int:
    """Nonzero entries of a patch."""
    return int(torch.count_nonzero(_bits(patch)))


class ServeDelta(NamedTuple):
    """One round's serving update: per-path XOR word patches and the new
    draw word.  ``codec`` guards against cross-codec application."""

    codec: str
    words: Dict[str, torch.Tensor]  # path -> XOR patch (zero = same)
    step: int  # round t+1's draw word


def make_delta(old: ServeState, new: ServeState) -> ServeDelta:
    """The broadcastable update taking a round-t server to round t+1."""
    if old.codec != new.codec:
        raise ValueError(f"delta across codecs ({old.codec!r} -> "
                         f"{new.codec!r}); re-broadcast in full instead")
    if set(old.words) != set(new.words):
        raise ValueError("delta requires identical zampled leaf sets")
    return ServeDelta(codec=new.codec,
                      words={p: word_delta(old.words[p], new.words[p])
                             for p in old.words},
                      step=as_word(new.step))


def _drawn_bits(spec, words: torch.Tensor, step, qbits,
                qpacked: bool = False) -> torch.Tensor:
    """The (n,) drawn mask bits of one leaf under the draw word: the
    serve kernels' draw (``ops.drawn_bits_at``) at every coordinate."""
    coords = torch.arange(spec.n, dtype=torch.int64, device=words.device)
    return ops.drawn_bits_at(spec, ops.serve_operand(words, qbits, qpacked),
                             step, coords, qbits, qpacked)


def delta_flipped_windows(sstate: ServeState,
                          delta: ServeDelta) -> Dict[str, torch.Tensor]:
    """{path: (num_windows,) bool}: the windows where a drawn bit flips,
    the exact invalidation map of ``delta`` for a cache keyed by window.
    Needs the pinned draw word (``delta.step == sstate.step``): with a
    changed one every bit re-rolls and the caller drops everything."""
    if as_word(delta.step) != as_word(sstate.step):
        raise ValueError("delta changes the draw word; the flip map is the "
                         "full set: invalidate the whole cache")
    qbits, qpacked = sstate.qbits, sstate.qpacked
    out = {}
    for path, patch in delta.words.items():
        spec = sstate.zspecs.specs[path]
        old_w = sstate.words[path]
        new_w = apply_word_delta(old_w, patch)
        flipped = (_drawn_bits(spec, old_w, sstate.step, qbits, qpacked)
                   != _drawn_bits(spec, new_w, sstate.step, qbits, qpacked))
        out[path] = flipped.reshape(spec.num_windows, spec.window).any(1)
    return out


def apply_delta(sstate: ServeState, delta: ServeDelta,
                cache=None) -> ServeState:
    """Hot-swap: patch a live server's words to the next round.

    The result equals ``make_serve_state`` on round t+1's broadcast bit
    for bit.  ``cache``: a live ``serve.cache.HotBlockCache`` carried
    across the swap; exactly the tiles whose drawn bits flip are dropped
    (every tile, if the draw word changed).  The retained tiles equal a
    fresh fill from the new words; ``cache.fill(new_state)`` refills
    the freed slots."""
    if delta.codec != sstate.codec:
        raise ValueError(f"delta is for codec {delta.codec!r}, state "
                         f"carries {sstate.codec!r}")
    if cache is not None:
        if as_word(delta.step) != as_word(sstate.step):
            cache.invalidate_all()
        else:
            for path, flipped in delta_flipped_windows(sstate,
                                                       delta).items():
                cache.invalidate_windows(path, flipped)
    words = {p: apply_word_delta(sstate.words[p], delta.words[p])
             for p in sstate.words}
    return sstate.replace_arrays({"words": words,
                                  "dense": dict(sstate.dense),
                                  "step": delta.step})


def lanes_delta(old_lanes: Dict[str, torch.Tensor],
                new_lanes: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """XOR patches of packed uint32 mask lanes (the drawn-mask wire of
    the packed transports): {path: patch}."""
    if set(old_lanes) != set(new_lanes):
        raise ValueError("lane delta requires identical leaf sets")
    return {p: word_delta(old_lanes[p], new_lanes[p]) for p in old_lanes}


def delta_report(old: ServeState, new: ServeState) -> Dict[str, object]:
    """Exact byte accounting of delta against full broadcast for one
    round step: per leaf and in total the words, the changed words, the
    changed words whose drawn bit also flips (what a tile cache feels),
    the delta's wire bytes (the cheaper of bitmap and coordinate list,
    plus 4 bytes of draw word) and the codec's full broadcast."""
    codec = get_codec(new.codec)
    if codec.packed:
        raise ValueError(
            f"delta_report does not meter the packed codec {codec.name!r}: "
            "a lane holds several words, so neither the changed-word count "
            "nor the bytes a word are defined (the JAX package's raises)")
    delta = make_delta(old, new)
    qbits = old.qbits
    wb = codec.bits // 8
    same_step = as_word(delta.step) == as_word(old.step)
    per_path = {}
    delta_bytes, full_bytes = 4, 0  # the draw word rides along
    changed_total = flipped_total = total = 0
    for path, patch in delta.words.items():
        n = patch.numel()
        changed = changed_words(patch)
        if same_step:
            spec = old.zspecs.specs[path]
            flips = int(torch.count_nonzero(
                _drawn_bits(spec, old.words[path], old.step, qbits)
                != _drawn_bits(spec, new.words[path], old.step, qbits)))
        else:
            flips = n
        d = delta_wire_bytes(n, changed, wb)
        f = score_downlink_bytes(codec, n)
        per_path[path] = {"words": n, "changed": changed, "flipped": flips,
                          "delta_bytes": d, "full_bytes": f}
        delta_bytes += d
        full_bytes += f
        changed_total += changed
        flipped_total += flips
        total += n
    return {"codec": new.codec, "words_total": total,
            "words_changed": changed_total,
            "words_flipped": flipped_total, "delta_bytes": delta_bytes,
            "full_bytes": full_bytes,
            "delta_vs_full": delta_bytes / full_bytes if full_bytes else 0.0,
            "per_path": per_path}
