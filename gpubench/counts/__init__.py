"""Operation and byte counts of kernels and steps, from a cell's shapes
only: a count reads the same whatever implements the work."""
