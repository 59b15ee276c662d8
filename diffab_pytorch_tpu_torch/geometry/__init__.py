"""SO(3) numerics and IGSO(3) tables."""
