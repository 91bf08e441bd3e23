"""Logical axes, the sharding law, collectives and parameter blocks."""
