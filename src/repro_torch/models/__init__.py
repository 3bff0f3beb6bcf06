"""The dense attention stack of the port: numerics, attention, model assembly."""
