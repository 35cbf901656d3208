"""Optimizer: AdamW and error-feedback int8 gradient compression."""
