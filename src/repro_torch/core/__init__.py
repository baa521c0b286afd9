"""Model layers for the port."""
