"""Retrieval metrics of the port."""
