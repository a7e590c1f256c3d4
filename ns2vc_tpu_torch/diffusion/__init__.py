"""Noise schedule and samplers of the port."""
