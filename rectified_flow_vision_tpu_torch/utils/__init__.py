"""Checkpoint I/O, reference ``.pt`` conversion and logging (numpy/torch only)."""
