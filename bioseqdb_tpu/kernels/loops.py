"""Loop helpers for SPMD-friendly device control flow."""

from __future__ import annotations

import os

import jax

# Unrolling state-machine steps amortizes the fixed cost of each
# while/fori iteration boundary. The value was chosen on another
# accelerator and is not measured on the GPU (ROADMAP Speed item 7).
# Env-tunable for A/B (BST_LOOP_UNROLL=1 disables).
LOOP_UNROLL = int(os.environ.get("BST_LOOP_UNROLL", "4"))


def chunked_while(cond, body, state, chunk: int = 32, unroll: int | None = None):
    """``while_loop`` that evaluates ``cond`` only every ``chunk``
    iterations of ``body``.

    Under SPMD partitioning a data-dependent ``cond`` (e.g.
    ``jnp.any(active)``) lowers to a cross-device collective per
    iteration; checking it at chunk boundaries cuts that sync cost by
    ``chunk``x. ``body`` must be a no-op for lanes that already finished
    (true of all the masked per-lane state machines here), so the up to
    ``chunk - 1`` extra iterations are harmless.

    ``unroll`` composes that many body calls per loop iteration, which
    amortizes the fixed cost of each iteration boundary over dependent-
    chain state machines with hundreds of trips.
    """
    if unroll is None:
        unroll = LOOP_UNROLL
    unroll = max(1, min(unroll, chunk))

    def inner(_, s):
        for _ in range(unroll):
            s = body(s)
        return s

    def outer(st):
        return jax.lax.fori_loop(0, chunk // unroll, inner, st)

    return jax.lax.while_loop(cond, outer, state)
