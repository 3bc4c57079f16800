"""A frozen copy of the parts of ``sage_slam_tpu_torch``'s plain PyTorch
modules (commit f5567e6) that turn an image into a keyframe's arrays:
``config``, ``geometry`` (camera, sampling, poses), ``models`` (the
networks) and ``ops`` (depth decoding, the feature and depth pyramids). The
reference computes a keyframe's arrays with it; later changes to the
program do not reach it. The BA step itself is ``reference/lm.py``, written
apart from the program."""
