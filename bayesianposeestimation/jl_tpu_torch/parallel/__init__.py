"""Scale-out: particle sharding over ``torch.distributed`` and the
process-level config sweep."""
