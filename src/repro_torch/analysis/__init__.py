"""Analytic cost models of the port (port of src/repro/analysis): the
parameter counts the roofline cost accounting (`obs.cost`) reads, and the
H100's published peaks."""
