"""Observability: the one record shape of every outward-flowing row."""
