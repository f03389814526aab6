"""Measurement scripts of the port (run as modules; nothing here runs on import)."""
