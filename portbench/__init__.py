"""The benchmark of the PyTorch/CUDA port (``bayesianposeestimation.jl_tpu_torch``).

``run.py`` runs one cell: ``python3 portbench/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>``. Everything that belongs to one
configuration, traffic mix or metric is a file of its own, found by its name:
``configs/<config>.json``, ``workloads/<cell>.json``, ``traffic/<kind>.py``,
``entries/<entry>.py`` (the calls into the port that a configuration drives),
``end_to_end/<metric>.py`` and ``metrics/<metric>.py`` (readers).
``reference/`` holds the plain reference and the frozen copies the check
uses; it imports nothing of the port and nothing of JAX.
"""
