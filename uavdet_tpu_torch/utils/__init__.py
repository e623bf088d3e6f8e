"""Utilities of the port: result containers, the weight bridge, seeding."""
