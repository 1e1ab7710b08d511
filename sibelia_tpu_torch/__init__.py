"""sibelia_tpu_torch — the PyTorch/CUDA port of sibelia_tpu.

Mirrors the JAX package's layout, so each module's counterpart has the
same path under ``sibelia_tpu/``.  It imports ``torch`` and never ``jax``,
and nothing of the JAX package: it carries its own copies of the host
modules (FASTA, graph, blocks, writers, aligners) and of the native C++
sources, which it builds with g++ at first use into ``native/build/``.  The
CUDA kernels are built with nvcc at first use into ``kernels/build/``.

Layout:
  core/     device choice, launch and sync accounting, numpy<->tensor,
            timings, and the reference's runtime twins (glibc rand,
            std::sort, boost::unordered, py2 dict order)
  io/       FASTA reader, output writers
  index/    packed k-mer keys, fused enumeration on the device, candidate
            scan, host ranking and enumeration
  kernels/  hand-written CUDA kernels for Hopper (csrc/) and wrappers
  graph/    working sequence, bifurcation store, randomize-and-enumerate
  native/   C++ engines (simplification, ranking, LAGAN stages), their
            loaders, and the engine runner with the device re-prefilter
  blocks/   BlockFinder, synteny block generation, post-processing
  align/    exact LAGAN / mlagan pipelines, SeqAn-style local alignment
  variants/ C-Sibelia's anchored aligner and variant caller, gap batches
            closed on the device
  cli/      command line entry points (Sibelia, C-Sibelia)
"""

VERSION = "3.0.7"  # reference compatibility version reported in outputs
