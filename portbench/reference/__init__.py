"""The benchmark's plain reference, in plain PyTorch and NumPy.

Frozen copies of the arithmetic the check re-derives: the BOP reader and
its PNG decoder, the host prep (crop camera, crop, prior point), the
rasteriser and the score epilogues, the SMC weights and the pose estimates.
Nothing here imports the port (``bayesianposeestimation``) or JAX, and
nothing here reads what the port made: every function takes the raw inputs
the benchmark hands both sides, and reads the port's outputs only to judge
them.
"""
