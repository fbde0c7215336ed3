"""Checkpoints: atomic, asynchronous, restored onto any device."""
