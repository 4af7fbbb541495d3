"""Configs, data building, checkpoints, the forwards and train steps, and
the train and test loops with their hooks."""
