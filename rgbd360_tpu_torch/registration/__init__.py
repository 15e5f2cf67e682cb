"""Registration engines of the port."""
