"""Observability hooks of the port (the full recorder is a later slice)."""
