"""Per-layer readers: ``<metric>.py`` with ``read(record)``, found by name."""
