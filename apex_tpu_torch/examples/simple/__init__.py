"""Port of the repo's ``examples/simple``."""
