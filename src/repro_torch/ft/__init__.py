"""Fault tolerance: the supervisor."""
