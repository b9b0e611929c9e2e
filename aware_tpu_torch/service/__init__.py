"""Service layer: load / embed / detect and the pattern codec."""
