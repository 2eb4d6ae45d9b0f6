"""Measurement scripts of the PyTorch/CUDA port, one module per script of
the JAX package's ``benchmarks/`` directory:

* ``python -m bjxa_tpu_torch.benchmarks.roofline_bound`` — the measured
  load/store bound of the words decode (``bench_roofline_bound.py``);
* ``... .load_variants`` / ``... .store_variants`` — load-side and store-side
  variants of the 8-bit decode (``bench_load_variants.py``,
  ``bench_store_variants.py``);
* ``... .ablate`` — the decode kernel with and without its PCM stores
  (``bench_ablate.py``);
* ``... .encode`` / ``... .corpus`` / ``... .segmented`` — the search kernel,
  the corpus engine and the segmented decode end to end
  (``bench_encode.py``, ``bench_corpus.py``, ``bench_segmented.py``).

Card-only scripts of the port's own: ``search_unroll`` and ``stream_store``
(kernel ablations), and ``short_stream.py``, run as a file with ``--root``
to time the short-stream path of any checkout's package.

The headline, ``python -m bjxa_tpu_torch.bench``, is the port of the root
``bench.py``.  Every script runs on the CUDA card unless
``BJXA_PLATFORM=cpu`` (a rehearsal: its numbers are host times of the plain
versions and say so in ``"device"``), prints one JSON object per line, and
times device work with CUDA events over many launches after a warm-up.
"""
