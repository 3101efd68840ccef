"""Deterministic synthetic LM data (own copy of ``repro.data``)."""
