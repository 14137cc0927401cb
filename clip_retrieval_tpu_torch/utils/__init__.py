"""Small helpers shared by the port's entry points."""
