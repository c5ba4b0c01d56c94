"""Traversal orders and the plain attention version of the paged path."""
