"""Small host utilities of the port (``logging``: the CLI's verbosity
tiers)."""
