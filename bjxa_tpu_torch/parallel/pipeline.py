"""The end-to-end device step: sharded corpus transcode.

Port of :mod:`bjxa_tpu.parallel.pipeline`.  One step = decode a batch of
XA streams, run the exhaustive profile-search re-encoder over the decoded
PCM, and reduce a global quality metric -- the codec-engine analog of a
"training step", exercising every hot stage (inflate, the filter, the
80-candidate search, deflate).

Sharding layout: files over ``dp``, channels over ``cp`` (stereo filters
are fully independent given their own state -- the free lane dimension the
reference exploits as two sequential calls, SURVEY §2.5).  All lane math is
elementwise, so shards never communicate; only the scalar metric reduction
crosses devices, as one sum on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bjxa_tpu_torch.ops.deflate import deflate_blocks
from bjxa_tpu_torch.ops.encode import encode_search
from bjxa_tpu_torch.ops.filter import decode_lanes
from bjxa_tpu_torch.ops.inflate import inflate_blocks
from bjxa_tpu_torch.ops.tables import BLOCK_SAMPLES
from bjxa_tpu_torch.parallel.mesh import Mesh


def _step(blocks: torch.Tensor, states: torch.Tensor, bits: int):
    """One shard's step on its device: ``(xa uint8[N, B, C, S], squared
    error sum float64, samples)``."""
    N, C, B, S = blocks.shape
    profiles, samples = inflate_blocks(blocks, bits)
    prof_l = profiles.permute(2, 0, 1).reshape(B, N * C)
    samp_l = samples.permute(2, 3, 0, 1).reshape(B, BLOCK_SAMPLES, N * C)
    pcm, _end, _valid = decode_lanes(prof_l, samp_l,
                                     states.reshape(N * C, 2))
    enc_prof, coded, recon, _ = encode_search(
        pcm, torch.zeros((N * C, 2), dtype=torch.int32, device=pcm.device),
        bits=bits,
    )
    err = (recon.to(torch.float32) - pcm.to(torch.float32)) ** 2
    xa = deflate_blocks(enc_prof, coded.transpose(1, 2), bits)
    xa = xa.reshape(B, N, C, S).permute(1, 0, 2, 3)
    return xa, err.sum(dtype=torch.float64), err.numel()


@dataclasses.dataclass(frozen=True)
class CorpusSharding:
    """The file x channel split of :func:`transcode_step`'s inputs over a
    ``(dp, cp)`` mesh: device ``[i, j]`` holds file block ``i`` of the
    ``dp`` axis and channel block ``j`` of the ``cp`` axis."""

    mesh: Mesh

    def shard(self, blocks, states) -> list:
        """``[(blocks part, states part)]``, row-major over the mesh, for
        ``blocks uint8[N, C, B, S]`` and ``states int32[N, C, 2]``, each
        part copied to its device without blocking."""
        nd, nc = self.mesh.devices.shape
        blocks, states = torch.as_tensor(blocks), torch.as_tensor(states)
        if blocks.shape[0] % nd or blocks.shape[1] % nc:
            raise ValueError(f"corpus_shardings: {tuple(blocks.shape[:2])}"
                             f" files x channels over a {nd}x{nc} mesh")
        out = []
        for i, (bf, sf) in enumerate(zip(blocks.chunk(nd), states.chunk(nd))):
            for j, (bc, sc) in enumerate(zip(bf.chunk(nc, 1),
                                             sf.chunk(nc, 1))):
                d = self.mesh.devices[i, j]
                out.append((bc.contiguous().to(d, non_blocking=True),
                            sc.to(torch.int32).contiguous().to(
                                d, non_blocking=True)))
        return out


def corpus_shardings(mesh: Mesh) -> CorpusSharding:
    """The input split of :func:`transcode_step` on a ``(dp, cp)`` mesh."""
    if mesh.axis_names != ("dp", "cp"):
        raise ValueError(f"corpus_shardings: want a (dp, cp) mesh, got"
                         f" {mesh.axis_names}")
    return CorpusSharding(mesh)


def transcode_step(blocks, states, *, bits: int,
                   sharding: CorpusSharding | None = None):
    """Decode + search-re-encode one batch; returns re-encoded blocks and a
    global mean-squared reconstruction error.

    Args:
      blocks: ``uint8[N, C, B, block_size]``.
      states: ``int32[N, C, 2]``.
      sharding: from :func:`corpus_shardings`: every shard's decode
        (:func:`~bjxa_tpu_torch.ops.filter.decode_lanes`, the filter
        kernel's samples entry on a card), search (kernel 7) and deflate
        run on its own device, every shard launched before any is read.
        Without it the whole batch runs on the device of ``blocks``.

    Returns ``(xa uint8[N, B, C, block_size] numpy, mse float32)``.
    """
    if sharding is None:
        blocks = torch.as_tensor(blocks)
        parts = [(blocks, torch.as_tensor(states, dtype=torch.int32).to(
            blocks.device))]
        nd, nc = 1, 1
    else:
        parts = sharding.shard(blocks, states)
        nd, nc = sharding.mesh.devices.shape
    outs = [_step(b, s, bits) for b, s in parts]
    xa = [o[0].cpu().numpy() for o in outs]
    rows = [np.concatenate(xa[i * nc:(i + 1) * nc], axis=2)
            for i in range(nd)]
    total = sum(float(o[1]) for o in outs)
    count = sum(o[2] for o in outs)
    return np.concatenate(rows, axis=0), np.float32(total / count)
