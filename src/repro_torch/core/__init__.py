"""Reservoir math of the port: spectra and bases (numpy), param structs,
scans, ridge solves, the model functions and the backend dispatch."""
