"""Host-side data access: NIfTI I/O, the H5 subject store, splits."""
