"""The structure layer on the host (numpy): PDB parsing and writing,
geometry, complex assembly, patches, backbone reconstruction; and the
designed-loop relaxation on the device (torch)."""
