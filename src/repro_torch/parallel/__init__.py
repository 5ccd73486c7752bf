"""Parallelism: sharding rules on a DeviceMesh, collectives, the GPipe schedule."""
