"""Configs, data building, checkpoints and the protocol's forwards."""
