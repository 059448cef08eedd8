"""direct12pbrrenderer — a deferred PBR render engine in JAX, run on a GPU.

A from-scratch rebuild of the capabilities of zrlhahaha/Direct12PBRRenderer
(D3D12/C++/HLSL) as an idiomatic JAX/XLA/Pallas framework:

* The D3D12 command-list/pass machinery becomes a single jit-compiled frame
  function composed by a declarative render graph (`graph.frame_graph`).
* The HLSL raster + compute shaders become batched jax.numpy stages
  (`ops.raster`, `ops.shading`, `ops.bloom`, ...), with two Pallas kernels
  through Triton on the GPU for the tile raster and the tile light loop.
* The reflection-based JSON/binary asset repository is preserved byte- and
  schema-compatible (`resource.serialization`) so scenes authored for the
  reference renderer load unchanged.
* The C++ runtime pieces of the reference (BC texture codecs, TLSF allocator,
  loose octree) are rebuilt as a native C++ library (`native/`) with ctypes
  bindings and pure-numpy fallbacks.

Reference layer map: SURVEY.md §1-2.
"""

__version__ = "0.1.0"
