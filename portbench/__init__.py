"""The benchmark of the PyTorch and CUDA port (``seamlesscloneoptimization_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON result line.
Everything a cell is made of is found by name: ``configs/<config>.json``,
``traffic/<traffic>.json``, the entry point its requests go through
``drivers/<driver>.py`` (named by the traffic file), ``metrics/<metric>.py``,
``kernels/<kernel>.py`` and ``limits/<cell>.json``. Nothing here imports
JAX or the JAX package; ``reference.py`` imports nothing of the port either.
"""
