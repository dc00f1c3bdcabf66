"""Helpers shared by the runtime: ``groups`` (parallel-group getters)."""
