"""Geometry ops: numpy plans on the host, torch gathers and scatters."""
