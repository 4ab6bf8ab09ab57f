"""Command-line drivers of the reference's regression configurations."""
