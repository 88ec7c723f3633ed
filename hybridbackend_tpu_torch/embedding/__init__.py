"""Embedding tables, lookup, stacking and sparse updates of the port."""
