"""The direct eval: volume pipeline, CSV writers and the driver."""
