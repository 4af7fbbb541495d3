"""Drivers: one module per kind of traffic, each with ``drive(run)``."""
