"""Resilience primitives of the port."""
