"""Analytic FLOP / byte model of the port's serving phases."""
