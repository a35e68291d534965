"""Helpers shared by the port: checkpoints, field output, timing on the card."""
