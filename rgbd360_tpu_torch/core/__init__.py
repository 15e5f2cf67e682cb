"""Frame build of the port."""
