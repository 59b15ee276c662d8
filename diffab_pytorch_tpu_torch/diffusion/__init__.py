"""Schedule and the three diffusions (sequence, coordinates, orientations)."""
