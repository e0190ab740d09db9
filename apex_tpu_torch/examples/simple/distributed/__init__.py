"""Port of ``examples/simple/distributed``: the DDP acceptance script."""
