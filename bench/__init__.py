"""The benchmark of ``repro_torch``, the PyTorch and CUDA port, on one H100.

``python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` and prints one JSON line. Everything a
cell needs is found by name (``spec``): its configuration in
``configs/<name>.json``, its traffic mix in ``traffic/<name>.json``, the
generator of its array in ``data/<name>.py``, its loop in
``loops/<name>.py`` and a reader per metric in ``metrics/<metric>.py``.
The yardstick lives here too, where the program cannot move it: the query
generator (``queries``), the plain reference and its lower-precision
control (``reference``), and the peaks, the work count and the busy-time
arithmetic (``roofline``). Nothing here imports JAX or the JAX package.
"""
