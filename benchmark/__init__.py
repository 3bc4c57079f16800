"""The benchmark of ``sage_slam_tpu_torch``, the PyTorch and CUDA port.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name from ``BENCHMARK.json`` at the root of the
checkout: a configuration is ``benchmark/configs/<config>.json``, a traffic
mix is ``benchmark/workloads/<traffic>.json``, which names the driver that
runs it (``benchmark/drivers/<driver>.py``), and a per-layer metric is the
reader ``benchmark/metrics/<metric>.py``. A new cell, configuration, traffic
mix or metric is a new file; no file here needs an edit for it.

The yardstick lives here too: the traffic generators (``traffic/``), the
seeded weights (``weights.py``), the table of peaks and the reduce's bound
(``peaks.py``), the reading of profiler traces (``trace.py``) and the plain
reference with the comparison that decides ``correct`` (``reference/``).
From the program the benchmark takes only the system under test and its
spans and kernel names.
"""
