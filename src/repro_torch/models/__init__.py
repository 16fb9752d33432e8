"""Model assembly for the port (``repro.models`` twin)."""
