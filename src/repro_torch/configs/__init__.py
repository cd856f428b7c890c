"""Configuration data of the port (the CARAT spaces only)."""
