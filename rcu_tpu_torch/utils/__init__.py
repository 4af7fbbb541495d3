"""Run ids, logging, the artifact writer pool and label helpers."""
