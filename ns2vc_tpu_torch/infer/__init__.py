"""Serving API of the port."""
