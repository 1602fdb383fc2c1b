"""Seeded generators of the configurations' matrices, one file each."""
