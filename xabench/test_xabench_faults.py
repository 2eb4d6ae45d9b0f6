"""A run with the timed path broken underneath comes out not correct:
once for each fault a cell can have (an answer altered where it is made;
the predictor state left unchanged from block to block; half of a corpus
batch left out).  The runs skip the harness's look for a card and drive
the rest of a run on the CPU at a small size."""

from __future__ import annotations

from unittest import mock

import pytest
import torch

from xabench._testing import run_small


def _flip(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its first element changed (its low bit flipped)."""
    t = t.clone()
    flat = t.view(-1)
    flat[0] ^= 1
    return t


def _altered(path: str):
    """Patch ``path`` so that its result comes back with one element
    changed."""
    mod, name = path.rsplit(".", 1)
    real = getattr(__import__(mod, fromlist=[name]), name)

    def bad(*a, **k):
        out = real(*a, **k)
        if isinstance(out, tuple):
            return (_flip(torch.as_tensor(out[0])).numpy()
                    if not torch.is_tensor(out[0]) else _flip(out[0]),
                    *out[1:])
        return _flip(out) if torch.is_tensor(out) else _flip(
            torch.from_numpy(out)).numpy()

    return mock.patch(path, bad)


def _stateless_search():
    """Every block searched from its stream's entry state: the state a
    step should carry is returned unchanged."""
    from bjxa_tpu_torch.ops import encode

    def bad(pcm, state, *, bits, run=None):
        B, S, L = pcm.shape
        lanes = pcm.permute(1, 0, 2).reshape(1, S, B * L)
        prof, coded, recon, _ = encode.encode_search(
            lanes, state.repeat(B, 1), bits=bits)
        back = lambda t: t.reshape(S, B, L).permute(1, 0, 2)  # noqa: E731
        return (prof.reshape(B, L), back(coded[0]), back(recon[0]),
                state)

    return mock.patch.object(encode, "encode_search_auto", bad)


def _stateless_stream_decode():
    """Every block of a one-shot decode from its stream's entry state."""
    from bjxa_tpu_torch.ops import decode

    def bad(payload, fmt, state, device):
        blocks = torch.from_numpy(decode.blocks_from_bytes(payload, fmt))
        C, B, S = blocks.shape
        pcm, _, valid = decode.decode_arrays(
            blocks.to(device).reshape(C * B, 1, S),
            state.repeat_interleave(B, 0), bits=fmt.bits)
        return (pcm.reshape(32, C, B).permute(2, 0, 1).reshape(B * 32, C),
                valid.reshape(C, B).T)

    return mock.patch.object(decode, "_decode_payload", bad)


def _stateless_batch_decode():
    from bjxa_tpu_torch.ops import decode
    from bjxa_tpu_torch.ops.cuda_decode import fused_decode_lanes

    def bad(buf, *, bits, blocks, lanes):
        nw, npr, _ = decode.packed_layout(blocks, lanes, bits)
        words = buf[:nw].reshape(blocks, bits, lanes)
        prof = buf[nw:nw + npr].view(torch.uint8)[:blocks * lanes]
        blk = decode.words_to_blocks(prof.reshape(blocks, lanes), words,
                                     bits=bits)
        one = blk.permute(1, 0, 2).reshape(1, blk.shape[1], blocks * lanes)
        state = buf[nw + npr:].reshape(lanes, 2).repeat(blocks, 1)
        pcm, _ = fused_decode_lanes(one, state, bits=bits)
        return pcm.reshape(32, blocks, lanes).permute(1, 0, 2).reshape(-1)

    return mock.patch("bjxa_tpu_torch.parallel.corpus.decode_batch_packed",
                      bad)


def _half_batch():
    """The corpus engine handed the first half of each group's files."""
    from bjxa_tpu_torch.parallel import corpus

    real = corpus._run_pipelined

    def bad(groups, *a, **k):
        half = {key: items[:(len(items) + 1) // 2]
                for key, items in groups.items()}
        return real(half, *a, **k)

    return mock.patch.object(corpus, "_run_pipelined", bad)


FAULTS = {
    "fixture15s.corpus_decode": {
        "answer_altered": lambda: _altered(
            "bjxa_tpu_torch.parallel.corpus.decode_batch_packed"),
        "state_unchanged": _stateless_batch_decode,
        "half_batch": _half_batch,
    },
    "fixture15s.file_decode": {
        "answer_altered": lambda: _altered("bjxa_tpu_torch.api.decode_bytes"),
        "state_unchanged": _stateless_stream_decode,
    },
    "fixture15s.corpus_encode": {
        "answer_altered": lambda: _altered(
            "bjxa_tpu_torch.parallel.corpus.encode_batch_blocks"),
        "state_unchanged": _stateless_search,
        "half_batch": _half_batch,
    },
    "fixture15s.file_encode": {
        "answer_altered": lambda: _altered(
            "bjxa_tpu_torch.api.encode_stream_blocks"),
        "state_unchanged": _stateless_search,
    },
}


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_sound_run_is_correct(cell):
    res = run_small(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(FAULTS)
                                        for f in FAULTS[c]])
def test_fault_is_not_correct(cell, fault):
    with FAULTS[cell][fault]():
        res = run_small(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_empty_window_is_not_correct(cell):
    res = run_small(cell, seconds=0.0)
    assert res["attempted"] == 0
    assert not res["correct"], res["checks"]
