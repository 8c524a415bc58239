"""The serving step of the port."""
