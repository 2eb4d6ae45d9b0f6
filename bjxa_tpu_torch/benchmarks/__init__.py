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
  (``bench_encode.py``, ``bench_corpus.py``, ``bench_segmented.py``);
* ``... .abi`` — whole-file decode through the drop-in C ABI on one host
  core, beside the reference binary when its sources are at hand
  (``bench_abi.py``);
* ``... .mesh_flat`` / ``... .multihost`` — the mesh path's words decode
  against its lanes decode on a one-device mesh, and a corpus job's
  files/s at 1, 2 and 4 processes (``bench_mesh_flat.py``,
  ``bench_multihost.py``).

Card-only scripts of the port's own: ``search_unroll``, ``stream_store``
and ``u8_ring`` (kernel ablations), and ``short_stream.py``, run as a file
with ``--root`` to time the kernels of any checkout's package.
``alu_pack`` (the ALU probe's ablations) builds on the card and rehearses
its plain twins on the CPU.

The headline, ``python -m bjxa_tpu_torch.bench``, is the port of the root
``bench.py``.  Every script runs on the CUDA card unless
``BJXA_PLATFORM=cpu`` (a rehearsal: its numbers are host times of the plain
versions and say so in ``"device"``), prints one JSON object per line, and
times device work with CUDA events over many launches after a warm-up.
"""
