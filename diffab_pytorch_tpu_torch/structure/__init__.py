"""The structure layer on the host (numpy): PDB parsing (in Python or
through the C++ library) and writing, geometry, complex assembly,
patches, backbone reconstruction, synthetic PDB text; and the
designed-loop relaxation on the device (torch)."""
