"""Serving engines of the port: the lockstep engine so far."""
