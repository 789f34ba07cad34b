"""dart_tpu_torch — the dart-tpu aligner on PyTorch and CUDA.

A port of the JAX package ``dart_tpu`` to one NVIDIA Hopper GPU, which
stands alone: it holds its own copies of the host code (``index``: the
index loader and builder; ``io``: the FASTX readers and the SAM/BAM
writers; ``native``: the C++ packer, chunk pipeline and encoders, built
with g++ at first use; ``pipeline``: seeding, chaining and the Python
finalize; ``evaluation``; ``config`` and ``constants``), the
orchestration (``aligner.DartAligner``) and the command line (``cli``),
so that it runs without ``dart_tpu`` installed. Its device engine: the
FM-index tables on the card (``ops.layout``, narrow below 2^31 text positions and wide
from there on), the seed-scan, SA-locate, K-mer table and MEM-walk
kernels written by hand in CUDA (``csrc/fm_kernels.cu``, built by
``ops.build``), their plain PyTorch versions (``ops.fm_plain``), and
the engine that serves them to the shared seeding code
(``ops.fm_torch.FMIndexTorch``). Off the main path it has the batched
gap DP of ``dart_tpu.ops.nw_pallas`` (``csrc/nw_kernels.cu``, plain
version ``ops.nw_plain``, batch entry ``ops.nw_torch.nw_align_batch``)
and the counterpart of ``__graft_entry__.entry()`` (``entry``: MEM
walks, then SA locate, on the toy index). Beyond one card it has the
(data, index) device grid of ``--mesh`` (``parallel.mesh``, with the
range-sharded table of ``ops.layout.ShardedTable`` read by the kernels'
``Sharded`` access), multi-host runs over ``torch.distributed``
(``parallel.distributed``) and ``entry.dryrun_multichip``.

This package imports ``torch`` and never ``jax``, nor anything of
``dart_tpu``.
"""

__version__ = "0.1.0"
