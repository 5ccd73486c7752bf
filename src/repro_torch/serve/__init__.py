"""Continuous-batching serving engine of the port."""
