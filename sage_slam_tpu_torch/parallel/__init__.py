"""Multi-device bundle adjustment on torch.distributed (port of
sage_slam_tpu/parallel): edge-sharded (sharded_ba) and keyframe-sharded
(sharded_store) LM steps; launch spawns the ranks of a process group."""
