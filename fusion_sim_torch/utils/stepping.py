"""Multi-step batching helpers (port of ``fusion_sim_tpu/utils/stepping.py``).

The reference batches a shell's steps into one ``lax.scan`` dispatch a
resort window.  PyTorch dispatches op by op, so here a batch is a loop;
the helpers keep the reference's signatures for code written against it.
``pow2_chunk`` quantizes chunk lengths to powers of two.
"""

from __future__ import annotations


def make_multi_step(step, length: int):
    """``state -> state`` applying ``step`` ``length`` times."""

    def multi(state):
        for _ in range(length):
            state = step(state)
        return state

    return multi


def make_window_step(step, resort, length: int):
    """``state -> state`` running one resort window: ``length`` steps, then
    the relayout ``resort``."""
    multi = make_multi_step(step, length)

    def window(state):
        return resort(multi(state))

    return window


def pow2_chunk(n_avail: int) -> int:
    """Largest power of two <= n_avail (>= 1)."""
    return 1 << (max(1, n_avail).bit_length() - 1)
