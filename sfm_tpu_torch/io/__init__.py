"""Image loading and point-cloud export (counterpart of ``sfm_tpu/io``):
numpy and ctypes only, over the repository's ``native/libsfm_io.so``."""
