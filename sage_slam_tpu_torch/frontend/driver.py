"""Threaded SLAM driver (port of sage_slam_tpu/frontend/driver.py).

Wires a SlamSystem onto the native C++ runtime the way the reference wires
DeepFactors onto pthreads (live_demo.cpp:52-258, deepfactors.cpp:1495-1505):

* the calling thread runs the frame loop (process_frame);
* a mapping worker at ``cfg.mapper.update_frequency`` Hz runs
  Mapper.mapping_step;
* a loop worker at ``cfg.loop.detection_frequency`` Hz runs the local and
  global loop ticks on the newest unsearched keyframe.

There is no driver-level lock: the backends snapshot the keyframe store
under its short lock, solve with it released and merge with per-row
version checks (mapping/keyframe_store.py). Every thread issues its work on
the default CUDA stream, so the card runs it in the order the lock gives.

A worker's exception is never swallowed: native.Runtime keeps the first
one and stops the workers; ``run`` re-raises it on the calling thread at
the next frame, and ``stop`` re-raises it after joining.

The first dense solve in a thread pays the solver libraries' set-up (on the
card, a cuSOLVER and a cuBLAS handle per thread; in a fresh process also
their loading). Each thread pays it once up front, before its first frame
or tick, timed apart as "solver set-up (<thread>)".
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import native
from ..utils import timing
from .slam import SlamSystem


class SlamDriver:
    def __init__(self, system: SlamSystem, use_native_threads: bool = True):
        self.system = system
        self.use_native = use_native_threads
        self.runtime: Optional[native.Runtime] = None
        self.kf_queue: Optional[native.TaskQueue] = None
        self._warmed: set = set()

    # ------------------------------------------------------------------

    def start(self):
        """Spawn the mapping and loop backends."""
        if not self.use_native:
            return
        self.runtime = native.Runtime()
        self.kf_queue = native.TaskQueue()
        self.runtime.spawn("mapping", self._mapping_tick, self.system.cfg.mapper.update_frequency)
        self.runtime.spawn("loop", self._loop_tick, self.system.cfg.loop.detection_frequency)

    def stop(self):
        """Stop and join the workers; re-raise a worker's exception."""
        runtime, self.runtime = self.runtime, None
        if runtime is None:
            return
        self.kf_queue.close()
        runtime.stop_all()
        runtime.join_all()
        runtime.close()
        self._warmed.clear()  # a later start runs new threads
        runtime.check()

    def check(self):
        """Re-raise a worker's exception on the calling thread."""
        if self.runtime is not None:
            self.runtime.check()

    # ------------------------------------------------------------------

    def _warm_solvers(self, thread: str):
        """The solvers' first call in this thread: a Cholesky solve, a small
        LU solve, a batched eigendecomposition, an SVD and a determinant,
        as the tracker, the matcher and the graph solves call them."""
        if thread in self._warmed:
            return
        self._warmed.add(thread)
        with timing.span(f"solver set-up ({thread})"):
            a = torch.eye(7, device=self.system.device) + 1.0  # positive definite
            u, _ = torch.linalg.cholesky_ex(a, upper=True)
            torch.cholesky_solve(a[:, :1], u, upper=True)
            torch.linalg.solve_ex(a[:6, :6], a[:6, :1])
            torch.linalg.eigh(a.expand(2, 7, 7))
            torch.linalg.svd(a[:3, :3])
            float(torch.linalg.det(a[:3, :3]))  # one read: every call has run

    def _mapping_tick(self):
        self._warm_solvers("mapping worker")
        with timing.span("mapping_tick"):
            if self.system.store.num_active >= 2:
                # snapshot -> solve -> merge; overlaps the frontend
                self.system.mapper.mapping_step()

    def _loop_tick(self):
        self._warm_solvers("loop worker")
        # drain the wake signal; the scheduling itself follows the searched
        # flags (the newest unsearched keyframe each tick)
        if self.kf_queue is not None:
            self.kf_queue.pop(timeout_ms=50)
        with timing.span("loop_tick"):
            self.system.local_loop_tick()
            self.system.global_loop_tick()

    # ------------------------------------------------------------------

    def run(self, camera_interface=None, max_frames: Optional[int] = None, frames=None):
        """The processing loop: bootstrap on the first frame, process_frame
        on the rest, then drain the loop backends and refine_mapping.

        Frames come from ``camera_interface.frames()`` (each record's image
        becomes a tensor on the system's device) or, with ``frames=``, are
        prebuilt FrameData, handed to bootstrap and process_frame as
        ``frame=``; give one of the two."""
        if (camera_interface is None) == (frames is None):
            raise ValueError("give exactly one of camera_interface and frames")
        system = self.system
        self._warm_solvers("frame loop")
        self.start()
        results = []
        try:
            source = frames if frames is not None else camera_interface.frames()
            for i, rec in enumerate(source):
                if max_frames is not None and i >= max_frames:
                    break
                self.check()
                if frames is not None:
                    img, fr = None, rec
                else:
                    img = torch.as_tensor(np.asarray(rec.image), dtype=torch.float32, device=system.device)
                    fr = None
                if system.store.num_active == 0:
                    system.bootstrap(rec.timestamp, img, frame=fr)
                    continue
                with timing.span("process_frame"):
                    res = system.process_frame(rec.timestamp, img, frame=fr)
                results.append(res)
                if res.new_keyframe:
                    if self.kf_queue is not None:
                        self.kf_queue.push(res.keyframe_id)
                    if not self.use_native:
                        system.mapper.mapping_step()
        finally:
            self.stop()
        # drain the loop backends: the reference joins its loop threads only
        # after the final RefineMapping, so keyframes made near the end are
        # still searched; with the workers stopped, this thread searches
        # every keyframe exactly once before the refinement
        for _ in range(system.store.num_active):
            un_l = system._newest_unsearched(system.store.local_loop_searched)
            un_g = system._newest_unsearched(system.store.global_loop_searched)
            if un_l is None and un_g is None:
                break
            system.local_loop_tick()
            system.global_loop_tick()
        system.refine_mapping()
        return results
