"""Model layers of the port."""
