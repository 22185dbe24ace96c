"""Workflow layer of the port (only its parameters so far)."""
