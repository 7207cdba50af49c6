"""Data-side transforms of the port (augmentations)."""
