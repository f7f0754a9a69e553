"""The benchmark of chipmunk_torch (see README.md)."""
