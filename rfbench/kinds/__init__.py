"""Kinds of traffic: each module drives one kind (``Run``: setup, window, free, check)."""
