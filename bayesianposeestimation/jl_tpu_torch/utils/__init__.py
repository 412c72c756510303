from . import artifacts, bop, decimate, evaluation, experiment_io, mesh_io, visualization
