"""The input pipeline (port of ``gif_tpu.data``): the native batch loader,
the FLAME datasets and their prefetching iterator, augmentations, and the
LMDB reader and importer."""
