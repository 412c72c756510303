"""Traffic generators, one module per kind, found by the ``generator`` a
cell's traffic names. Each reads only the cell's parameters and the seed."""
