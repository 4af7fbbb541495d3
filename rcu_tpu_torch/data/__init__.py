"""Host-side data access: NIfTI I/O, the H5 subject store, the ISIC folder,
collectors, splits, the loader and the assemblers."""
