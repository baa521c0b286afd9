"""Model forwards for the port."""
