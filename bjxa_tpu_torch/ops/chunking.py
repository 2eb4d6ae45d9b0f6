"""The chunk schedule shared by the chunked decoders.

A stream's (or lane's) blocks are cut into K chunks, and the chunks' entry
states are solved by an exact fixed point: chunk 0 starts at the true
entry state, the others at zeros, and each round makes chunk k-1's end
chunk k's next start, so after r rounds chunks 0..r are exact.  The host
pipelines (:mod:`bjxa_tpu_torch.ops.decode`) run the rounds one launch at
a time through :func:`fixpoint_states`; the cooperative kernels
(``csrc/chunk_fixpoint.cuh``) run the same rounds inside one launch, and
their plain versions use :func:`fixpoint_states` to count them.

This module depends on nothing else of the package, so the pipeline and
the kernel wrappers can all import it.
"""

from __future__ import annotations

import torch

#: Threads of a CTA (``kThreads`` in ``csrc/adpcm.cuh``).
CTA_THREADS = 128
#: The fewest blocks a chunk keeps: state transients die within ~5 blocks,
#: so the fixed point converges in a few rounds.
MIN_CHUNK_BLOCKS = 8
#: Work items the cooperative kernels give an SM where there are too few
#: lanes to fill the card: K is the least that gives every SM this many (10
#: warps), keeping :data:`MIN_CHUNK_BLOCKS` blocks a chunk.  Ten warps an
#: SM keep the loads in flight, and fewer, longer chunks settle in fewer
#: rounds, each of which re-reads the input: on a corpus batch K = B/16
#: beat B/8 and B/32 on the H100 (``PERF.md``, section 6).
TARGET_LANES_PER_SM = 320


def word_chunks(B: int, chunks: int) -> tuple[int, int]:
    """``(K, Bc)`` for ``B`` blocks asked to split into ``chunks``: Bc =
    ceil(B / chunks), and K = ceil(B / Bc), so that no chunk is empty and
    only the last one may be short.  ``B = 0`` gives ``(1, 0)``."""
    if chunks < 1:
        raise ValueError(f"word_chunks: {chunks} chunks")
    if B == 0:
        return 1, 0
    Bc = -(-B // min(chunks, B))
    return -(-B // Bc), Bc


def fixpoint_states(run, anchor, K: int, C: int, max_iters: int):
    """Iterate chunk boundary states to the exact fixed point.

    ``run(states_flat int32[K*C, 2], with_output) -> (pcm|None,
    end int32[K*C, 2])`` decodes every chunk lane from the given input
    states.  Chunk 0 is anchored at ``anchor`` (the true entry state), so
    after i rounds chunks 0..i hold exact states; the loop exits as soon
    as nothing changes (integer equality: exactness is certain, not
    probabilistic).  Each round costs one host sync (the equality test).

    Returns ``(converged [K, C, 2], iterations)``; the count starts at 1
    after the first propagation, as in the JAX package.
    """

    def propagate(states):
        _, end = run(states.reshape(K * C, 2), False)
        return torch.cat([anchor[None], end.reshape(K, C, 2)[:-1]], dim=0)

    prev = torch.zeros((K, C, 2), dtype=torch.int32, device=anchor.device)
    prev[0] = anchor
    states = propagate(prev)
    iters = 1
    while iters < max_iters and not torch.equal(states, prev):
        prev, states = states, propagate(states)
        iters += 1
    return states, iters
