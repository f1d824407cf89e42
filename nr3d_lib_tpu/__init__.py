"""nr3d_lib_tpu — JAX/XLA/Pallas framework for 3D neural rendering.

A from-scratch re-design of the capabilities of PJLab-ADG/nr3d_lib
(multi-level tensorial grid encodings, permutohedral encodings, occupancy-grid
accelerated ray marching, packed-segment operators, NeuS/NeRF volume rendering,
sphere tracing; single / batched / dynamic / forest scenes) built idiomatically
for accelerators: static-shape padded ragged buffers, `lax`-native control
flow, plain XLA formulations (a Pallas kernel only where it measurably
wins), and `jax.sharding` meshes for scale-out.

Layer map (mirrors reference SURVEY.md §1):
  L0 infra      : config, fmt, logger, checkpoint, profile, utils, parallel/
  L1 kernels    : ops/ (XLA implementations)
  L2 ray/pack   : graphics/ (pack_ops, raymarch, raysample, raytest, cameras)
  L3 neural ops : models/grid_encodings, models/blocks, embedders, embeddings
  L4 accel/space: models/accelerations, models/spatial
  L5 render alg : graphics/nerf, graphics/neus, graphics/sphere_trace
  L6 fields     : models/fields*, attributes
"""

__version__ = "0.1.0"
