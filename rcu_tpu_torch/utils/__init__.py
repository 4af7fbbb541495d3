"""Run ids and logging."""
