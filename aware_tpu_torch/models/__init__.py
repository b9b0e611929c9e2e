"""The keyed detector network."""
