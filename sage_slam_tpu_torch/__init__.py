"""sage_slam_tpu_torch — the PyTorch/CUDA port of sage_slam_tpu.

The JAX package ``sage_slam_tpu`` stays the reference. This package mirrors
its module paths so that each function's counterpart is easy to find, and
runs on an NVIDIA GPU (Hopper, ``sm_90a``). The one hand-written kernel of
the window-BA path is the photometric J^T W J reduce
(``ops/photo_reduce.py`` + ``ops/csrc/photo_reduce.cu``).

Package layout (the ported slice):
  config.py   own copy of the configuration dataclasses
  device.py   device resolution and float32 precision settings
  geometry/   SE3, pinhole cameras, bilinear gather primitives
  ops/        pyramid, photometric / geometric / prior factors, the reduce
  solver/     PSD correction, Hessian assembly, LM loop, window BA
  models/     the depth and feature networks
  mapping/    keyframe store, mapper (frame build, windowed BA step),
              checkpoint save/resume
  tracker/    descriptor matching, robust registration, the LM tracker
  loop/       BoW vocabulary and database, the pose-scale graph
  frontend/   SlamSystem: tracking, keyframe decisions, loop closure,
              refinement; SlamDriver: the mapping and loop threads
  native/     the C++ runtime (threads, queue, profiler, hull), g++ at
              first use
  utils/      host tic/toc timing, torch.profiler traces
  io/         TUM trajectory files, dataset readers (Bowl3D with ground truth)
  eval/       ATE with Sim3/SE3 alignment, depth RMSE
  training/   network-config sidecars (the rest of training is to port)
  viz/        headless map, depth and warp renderings (matplotlib)
  demo/       the CLIs: run_slam, result_viewer, voc_builder
  convert.py  numpy fields of the JAX package's structures -> torch
  synthetic.py  synthetic BA problems and videos
  _build.py   nvcc build of the CUDA sources at first use

It imports neither ``jax`` nor ``sage_slam_tpu``.
"""

__version__ = "0.1.0"
