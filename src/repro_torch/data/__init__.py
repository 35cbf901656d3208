"""Deterministic, step-indexed synthetic LM data."""
